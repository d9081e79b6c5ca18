// Kernels B11 (closest hit, and its any-hit variant) and B12 (primary hit)
// of the general render path, for scenes of up to 16,384 triangles.
//
// Replace restir_tpu/ops/pallas/intersect_kernel.py: _closest_kernel
// (intersect_closest_pallas; its any-hit use test_occlusion_pallas) and
// _primary_kernel (primary_hit_pallas). The TPU kernels test a ray tile
// against 128-triangle blocks with bf16-split matmuls on the MXU; here one
// thread carries one ray through every triangle with exact float32 plane
// tests (di_core.cuh's plane_hit, the unit-triangle rows of
// tables.plane_table).
//
// Bound: FMA throughput. A ray costs one plane test of ~39 FLOP per
// triangle (the table's zero padding rows are not walked), so a
// 1080p frame on the 426-triangle headline scene is ~3.4e10 FLOP
// (~0.5 ms at 67 TFLOP/s); the rays and outputs are ~50-200 MB, a few
// hundredths of that. The design keeps the triangle rows out of device
// memory's way: each 256-thread block stages 256 plane rows (12 KB) at a
// time in shared memory and every thread of the block reads them from
// there, so the loop runs on shared-memory broadcasts and FMAs.
//
// The closest hit keeps the first (lowest-index) triangle on ties, as the
// TPU kernel's argmin and strict block fold do; a miss writes dist inf,
// barycentrics 0 and primitive -1. The any-hit variant stops a ray at
// its first hit nearer than the limit, which gives the closest-hit form's
// boolean. B12 then reads the winner's attribute row once and its
// material row once; a miss interpolates a zero row and so reads
// material row 0, as the TPU kernel's zero carry does.
#include "di_core.cuh"

using namespace restir;

namespace {

constexpr int BLOCK = 256;
constexpr int PCHUNK = 256;  // plane rows staged in shared memory per pass

// Stage plane rows [base, base + PCHUNK) into sp; every thread of the
// block must call it. Returns the number of rows staged.
__device__ __forceinline__ int stage_planes(float* sp,
                                            const float* __restrict__ planes,
                                            int base, int n_tris) {
  const int rows = min(PCHUNK, n_tris - base);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * 12; i += blockDim.x)
    sp[i] = planes[(size_t)base * 12 + i];
  __syncthreads();
  return rows;
}

struct Best {
  float t;
  int prim;
  float u, v;
};

// Closest hit over all plane rows (ties to the lowest row).
__device__ __forceinline__ Best closest_loop(float* sp,
                                             const float* __restrict__ planes,
                                             int n_tris, bool live, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz) {
  Best b = {RESTIR_BIG, -1, 0.0f, 0.0f};
  for (int base = 0; base < n_tris; base += PCHUNK) {
    const int rows = stage_planes(sp, planes, base, n_tris);
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      float u, v;
      const float t = plane_hit(sp + j * 12, ox, oy, oz, dx, dy, dz, u, v);
      if (t > 0.0f && t < b.t) {
        b.t = t;
        b.prim = base + j;
        b.u = u;
        b.v = v;
      }
    }
  }
  return b;
}

__device__ __forceinline__ void load3(const float* __restrict__ a, int p,
                                      float& x, float& y, float& z) {
  x = a[(size_t)p * 3];
  y = a[(size_t)p * 3 + 1];
  z = a[(size_t)p * 3 + 2];
}

__global__ void __launch_bounds__(BLOCK)
    closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ planes, int n_tris,
                   float* __restrict__ dist, float* __restrict__ bary,
                   int* __restrict__ prim, int r) {
  __shared__ float sp[PCHUNK * 12];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  if (live) {
    load3(o, p, ox, oy, oz);
    load3(d, p, dx, dy, dz);
  }
  const Best b = closest_loop(sp, planes, n_tris, live, ox, oy, oz, dx, dy, dz);
  if (!live) return;
  const bool hit = b.t < RESTIR_BIG;
  dist[p] = hit ? b.t : __int_as_float(0x7f800000);
  bary[(size_t)p * 2] = hit ? b.u : 0.0f;
  bary[(size_t)p * 2 + 1] = hit ? b.v : 0.0f;
  prim[p] = hit ? b.prim : -1;
}

// Segment x -> y: occluded iff a triangle is hit at 0 < t < |y - x| - 2e-4
// from x + d 1e-5 (test_occlusion_pallas). Lanes with active[p] == 0 are
// not traced and read 0.
__global__ void __launch_bounds__(BLOCK)
    any_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const unsigned char* __restrict__ active,
               const float* __restrict__ planes, int n_tris,
               unsigned char* __restrict__ occluded, int r) {
  __shared__ float sp[PCHUNK * 12];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = p < r && (active == nullptr || active[p] != 0);
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float limit = 0.0f;
  if (live) {
    float xx, xy, xz, yx, yy, yz;
    load3(x, p, xx, xy, xz);
    load3(y, p, yx, yy, yz);
    const float sx = yx - xx, sy = yy - xy, sz = yz - xz;
    const float len = sqrtf(sx * sx + sy * sy + sz * sz);
    const float den = fmaxf(len, 1e-20f);
    dx = sx / den;
    dy = sy / den;
    dz = sz / den;
    ox = xx + dx * 1e-5f;
    oy = xy + dy * 1e-5f;
    oz = xz + dz * 1e-5f;
    limit = len - 2e-4f;
  }
  bool blocked = false;
  for (int base = 0; base < n_tris; base += PCHUNK) {
    const int rows = stage_planes(sp, planes, base, n_tris);
    if (!live || blocked) continue;
    for (int j = 0; j < rows; ++j) {
      float u, v;
      const float t = plane_hit(sp + j * 12, ox, oy, oz, dx, dy, dz, u, v);
      if (t > 0.0f && t < limit) {
        blocked = true;
        break;
      }
    }
  }
  if (p < r) occluded[p] = blocked ? 1 : 0;
}

// Pack channels of B12 (intersect_kernel.py:101-106).
enum {
  C_DIST = 0, C_U = 1, C_V = 2, C_POS = 3, C_NORM = 6, C_UV = 9, C_MTYPE = 11,
  C_BCOLOR = 12, C_METAL = 15, C_ROUGH = 16, C_IOR = 17, C_BMAP = 18,
  C_MMAP = 19, C_RMAP = 20, C_NMAP = 21, C_MATID = 22, C_PRIM = 23
};

__global__ void __launch_bounds__(BLOCK)
    primary_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ planes, int n_tris,
                   const float* __restrict__ attr,
                   const float* __restrict__ mat, int n_mat,
                   float* __restrict__ out, int r) {
  __shared__ float sp[PCHUNK * 12];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  if (live) {
    load3(o, p, ox, oy, oz);
    load3(d, p, dx, dy, dz);
  }
  const Best b = closest_loop(sp, planes, n_tris, live, ox, oy, oz, dx, dy, dz);
  if (!live) return;
  const bool hit = b.t < RESTIR_BIG;
  const float u = hit ? b.u : 0.0f, v = hit ? b.v : 0.0f;
  float a[25];
  const float* at = attr + (size_t)(hit ? b.prim : 0) * 32;
#pragma unroll
  for (int j = 0; j < 25; ++j) a[j] = hit ? at[j] : 0.0f;
  const int mat_id = __float2int_rz(a[24]);
  const bool mat_ok = mat_id >= 0 && mat_id < n_mat;
  const float* mr = mat + (size_t)(mat_ok ? mat_id : 0) * 16;
  auto M = [&](int j) { return mat_ok ? mr[j] : 0.0f; };

  float* g = out + p;
  auto put = [&](int c, float val) { g[(size_t)c * r] = val; };
  float n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(C_POS + k, a[k] + u * a[3 + k] + v * a[6 + k]);
    n[k] = a[9 + k] + u * a[12 + k] + v * a[15 + k];
  }
  const float nlen =
      sqrtf(fmaxf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(C_NORM + k, n[k] / nlen);
    put(C_BCOLOR + k, M(1 + k));
  }
  put(C_DIST, hit ? b.t : __int_as_float(0x7f800000));
  put(C_U, u);
  put(C_V, v);
  put(C_UV, a[18] + u * a[20] + v * a[22]);
  put(C_UV + 1, a[19] + u * a[21] + v * a[23]);
  put(C_MTYPE, M(0));
  put(C_METAL, M(4));
  put(C_ROUGH, M(5));
  put(C_IOR, M(6));
  put(C_BMAP, M(7));
  put(C_MMAP, M(8));
  put(C_RMAP, M(9));
  put(C_NMAP, M(10));
  put(C_MATID, a[24]);
  put(C_PRIM, hit ? (float)b.prim : -1.0f);
}

inline int grid(int r) { return (r + BLOCK - 1) / BLOCK; }

}  // namespace

// o, d: float32 [R, 3]; planes: [>= n_tris, 12]. Writes dist [R], bary
// [R, 2], prim [R].
extern "C" int restir_closest_hit(const float* o, const float* d,
                                  const float* planes, int n_tris, float* dist,
                                  float* bary, int* prim, int r,
                                  void* stream) {
  if (r <= 0 || n_tris <= 0) return (int)cudaErrorInvalidValue;
  closest_kernel<<<grid(r), BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, planes, n_tris, dist, bary, prim, r);
  return (int)cudaGetLastError();
}

// x, y: float32 [R, 3]; active: null or bool [R]. Writes occluded bool [R].
extern "C" int restir_any_hit(const float* x, const float* y,
                              const unsigned char* active,
                              const float* planes, int n_tris,
                              unsigned char* occluded, int r, void* stream) {
  if (r <= 0 || n_tris <= 0) return (int)cudaErrorInvalidValue;
  any_kernel<<<grid(r), BLOCK, 0, (cudaStream_t)stream>>>(
      x, y, active, planes, n_tris, occluded, r);
  return (int)cudaGetLastError();
}

// o, d: float32 [R, 3]; attr [N, 32]; mat [n_mat, 16]. Writes the
// [24, R] pack.
extern "C" int restir_primary_hit(const float* o, const float* d,
                                  const float* planes, int n_tris,
                                  const float* attr, const float* mat,
                                  int n_mat, float* out, int r,
                                  void* stream) {
  if (r <= 0 || n_tris <= 0 || n_mat <= 0) return (int)cudaErrorInvalidValue;
  primary_kernel<<<grid(r), BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, planes, n_tris, attr, mat, n_mat, out, r);
  return (int)cudaGetLastError();
}
