// Kernels B11 (closest hit, and its any-hit variant) and B12 (primary hit)
// of the general render path's brute-force method, and B13 (closest, any
// and primary hit) and B14 (the BVH heatmap) of its MTBVH walk.
//
// Replace restir_tpu/ops/pallas/intersect_kernel.py: _closest_kernel
// (intersect_closest_pallas; its any-hit use test_occlusion_pallas) and
// _primary_kernel (primary_hit_pallas). The TPU kernels test a ray tile
// against 128-triangle blocks with bf16-split matmuls on the MXU; here one
// thread walks one ray through the scene's MTBVH (bvh.cuh's stackless
// closest_walk / occluded_walk on the node rows with their boxes copied
// in, `BvhRows`, the table B1, B6, B7 and B8 read) and tests only the
// triangles of the leaves it reaches: on the 426-triangle headline scene
// ~100 box tests and 3-5 plane tests per ray, where a loop over every row
// did 426 plane tests.
//
// Numerics: the leaf test is gi_core.cuh's plane_hit (`gi::GiRay`), the
// arithmetic of the plain twin ops/intersect_bf.py on the card, and the
// any-hit ray is gi::occlusion_ray, intersect_bf.occlusion_ray's. This
// source builds with -fmad=false (ops/kernels/_build.py), so B12's
// interpolation rounds product by product and sum by sum as primary_ref
// (ops/kernels/intersect.py) does. The walk returns the every-row loop's
// hit (padded boxes, the cull slack, ties to the lowest triangle id), so
// B11 and B12 equal their twins bit for bit.
//
// Bound: counted work (box and plane tests, B12's interpolation) and
// bytes (B12 writes a 96-byte pack per ray, ~0.25 GB per 1080p launch)
// each give ~0.08 ms at 1080p, but the walks are chains of dependent
// loads through the read-only cache (the headline scene's rows and
// planes, ~185 KB, stay in L1 / L2), so a warp waits out the latency of
// its longest walk. The COUNT builds write each ray's box and plane
// tests, from which chip_smoke.py counts the work these inputs take; the
// builds without counters carry no counting code.
//
// Launch shape of B13's primary and any hit and of B14: a caller that
// has the batch's geometry (one ray per pixel of a frame or row band from
// global pixel pix0: every render path) gets 8x4-pixel warps (common.cuh,
// tile_pixel), as B6 and B7 launch; a warp's rays then leave one patch of
// the image and walk nearly the same nodes, so its node-row loads touch
// fewer cache lines. The walks wait on those loads rather than on lanes
// that idle in a warp: persistent warps that refill idle lanes from a ray
// queue ran slower at every refill threshold tried, since refilled lanes
// hold unrelated rays (PERF.md, the B13 redesign). B12 and batches
// without geometry launch in ray order. B13's primary hit reads the
// winner's attribute row as float4 loads, and the walks divide out a
// leaf's barycentrics only for a hit they keep. B14's walk (bvh.cuh,
// heat_walk) keeps only the best distance, steps the absolute row index
// and runs the slab test of the ray's octant, 4 min / max per box test in
// place of 10: its loop issues 35 SASS instructions per box test, 15 on
// the ALU pipe that the min / max share, where exact_closest_walk's
// issued 42 and 16 (PERF.md, the B14 redesign). B13's closest hit, the
// ray query, has no pixel geometry: its caller keys the rays (sort.cu:
// the walk's class, the table and octant, first) and sorts them, and
// slot i walks ray perm[i] on the same octant loops, keeping its hit, so
// nearly every warp runs one loop on neighbouring rays (PERF.md, the
// redesign of B13's closest hit).
//
// The closest hit keeps the lowest triangle id on ties, as the TPU
// kernel's argmin and strict block fold do; a miss, and a zero or
// non-finite direction, writes dist inf, barycentrics 0 and primitive -1.
// The any-hit variant stops a ray at its first hit nearer than the limit,
// which gives the closest-hit form's boolean. B12 then reads the winner's
// attribute row once and its material row once; a miss interpolates a
// zero row and so reads material row 0, as the TPU kernel's zero carry
// does. Lanes with active[p] == 0 (dead paths) are not walked: the any hit
// reads 0, B12 writes the miss pack.
#include "bvh.cuh"
#include "gi_core.cuh"

using namespace restir;
using gi::GiRay;
using gi::V3;

namespace {

constexpr int BLOCK = 128;
constexpr float F32_EPS = 1.1920928955078125e-07f;  // 2^-23, float32 epsilon

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int p) {
  return gi::v3(a[(size_t)p * 3], a[(size_t)p * 3 + 1], a[(size_t)p * 3 + 2]);
}

__device__ __forceinline__ GiRay load_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          int p) {
  const V3 a = load3(o, p), b = load3(d, p);
  return {a.x, a.y, a.z, b.x, b.y, b.z};
}

__device__ __forceinline__ bool is_live(const unsigned char* __restrict__ active,
                                        int p) {
  return active == nullptr || active[p] != 0;
}

// A batch with geometry holds one ray per pixel of a band of r pixels
// from global pixel pix0, row-major in a frame `width` wide (a whole
// frame: pix0 = 0); TILES launches PIX_BLOCK threads on tile_grid(width,
// pix0, r) over it. LINEAR launches ray p on thread p.
enum Launch { LINEAR = 0, TILES = 1 };

// Ray index of this thread, -1 for none.
template <int L>
__device__ __forceinline__ int ray_of(int width, int pix0, int r) {
  if (L == TILES) {
    const int g = tile_pixel(width, pix0, r);
    return g < 0 ? -1 : g - pix0;
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  return p < r ? p : -1;
}

// counts [2, R]: box tests, plane tests of ray p
template <bool COUNT>
__device__ __forceinline__ void put_counts(int* __restrict__ counts, int r,
                                           int p, const WalkCount& n) {
  if (COUNT) {
    counts[p] = n.boxes;
    counts[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   BvhRows bvh, float* __restrict__ dist,
                   float* __restrict__ bary, int* __restrict__ prim,
                   int* __restrict__ counts, int r) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  WalkCount n = {0, 0};
  int id;
  float u, v;
  const float t = closest_walk<COUNT>(bvh, load_ray(o, d, p), id, u, v, n);
  dist[p] = id >= 0 ? t : __int_as_float(0x7f800000);
  bary[(size_t)p * 2] = u;
  bary[(size_t)p * 2 + 1] = v;
  prim[p] = id;
  put_counts<COUNT>(counts, r, p, n);
}

// Segment x -> y: occluded iff a triangle is hit at 0 < t < |y - x| - 2e-4
// from x + d 1e-5 (test_occlusion_pallas).
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    any_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const unsigned char* __restrict__ active, BvhRows bvh,
               unsigned char* __restrict__ occluded,
               int* __restrict__ counts, int r) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  WalkCount n = {0, 0};
  bool blocked = false;
  if (is_live(active, p)) {
    float limit;
    const GiRay ray = gi::occlusion_ray(load3(x, p), load3(y, p), limit);
    blocked = occluded_walk<COUNT>(bvh, ray, limit, -1, n);
  }
  occluded[p] = blocked ? 1 : 0;
  put_counts<COUNT>(counts, r, p, n);
}

// Pack channels of B12 (intersect_kernel.py:101-106).
enum {
  C_DIST = 0, C_U = 1, C_V = 2, C_POS = 3, C_NORM = 6, C_UV = 9, C_MTYPE = 11,
  C_BCOLOR = 12, C_METAL = 15, C_ROUGH = 16, C_IOR = 17, C_BMAP = 18,
  C_MMAP = 19, C_RMAP = 20, C_NMAP = 21, C_MATID = 22, C_PRIM = 23
};

// The Moller-Trumbore leaf test of B13 / B14 (intersect_triangle, with
// the reference's sign flip, intersections.h:17-54): row = v0, v1, v2,
// pad. Returns t > 0 on a hit, else -1; leaf.bary(u, v) then divides out
// the weights of v1, v2, which the walks do only for a hit they keep.
struct MtLeaf {
  float bx, by, det;
  __device__ __forceinline__ void bary(float& u, float& v) const {
    u = bx / det;
    v = by / det;
  }
};

struct MtRay {
  using Leaf = MtLeaf;
  float ox, oy, oz, dx, dy, dz;
  __device__ __forceinline__ float hit(const float* __restrict__ row,
                                       MtLeaf& leaf) const {
    const float4* q = reinterpret_cast<const float4*>(row);
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const float e01x = a.w - a.x, e01y = b.x - a.y, e01z = b.y - a.z;
    const float e02x = b.z - a.x, e02y = b.w - a.y, e02z = c.x - a.z;
    const float px = dy * e02z - dz * e02y, py = dz * e02x - dx * e02z,
                pz = dx * e02y - dy * e02x;
    float det = px * e01x + py * e01y + pz * e01z;
    const bool nondegenerate = fabsf(det) >= F32_EPS;
    float wx = ox - a.x, wy = oy - a.y, wz = oz - a.z;
    if (det < 0.0f) {
      wx = -wx;
      wy = -wy;
      wz = -wz;
    }
    det = fabsf(det);
    const float bx = wx * px + wy * py + wz * pz;
    const float qx = wy * e01z - wz * e01y, qy = wz * e01x - wx * e01z,
                qz = wx * e01y - wy * e01x;
    const float by = dx * qx + dy * qy + dz * qz;
    const bool inside =
        bx >= 0.0f && bx <= det && by >= 0.0f && bx + by <= det;
    const float det_safe = det > 0.0f ? det : 1.0f;
    const float t = (e02x * qx + e02y * qy + e02z * qz) / det_safe;
    leaf = {bx, by, det_safe};
    return nondegenerate && inside && t > 0.0f ? t : -1.0f;
  }
};

__device__ __forceinline__ MtRay load_mt_ray(const float* __restrict__ o,
                                             const float* __restrict__ d,
                                             int p) {
  const V3 a = load3(o, p), b = load3(d, p);
  return {a.x, a.y, a.z, b.x, b.y, b.z};
}

// Primary hit of B12 (plane test, padded rows; MT == false) or B13 (exact
// walk, Moller-Trumbore; MT == true), then the same pack.
template <bool COUNT, bool MT, int L>
__global__ void __launch_bounds__(L == TILES ? PIX_BLOCK : BLOCK)
    primary_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const unsigned char* __restrict__ active, BvhRows bvh,
                   const float* __restrict__ attr,
                   const float* __restrict__ mat, int n_mat,
                   float* __restrict__ out, int* __restrict__ counts,
                   int width, int pix0, int r) {
  const int p = ray_of<L>(width, pix0, r);
  if (p < 0) return;
  WalkCount n = {0, 0};
  int id = -1;
  float t = RESTIR_BIG, u = 0.0f, v = 0.0f;
  if (is_live(active, p)) {
    if (MT) {
      t = exact_closest_walk<COUNT>(bvh, load_mt_ray(o, d, p), id, u, v, n);
    } else {
      t = closest_walk<COUNT>(bvh, load_ray(o, d, p), id, u, v, n);
    }
  }
  const bool hit = id >= 0;
  float a[25];
  const float* at = attr + (size_t)(hit ? id : 0) * 32;
  if (MT) {  // B13 reads the 128-byte row as float4 loads
    const float4* q = reinterpret_cast<const float4*>(at);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float4 w = hit ? __ldg(q + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      a[4 * j] = w.x;
      a[4 * j + 1] = w.y;
      a[4 * j + 2] = w.z;
      a[4 * j + 3] = w.w;
    }
    a[24] = hit ? __ldg(at + 24) : 0.0f;
  } else {
#pragma unroll
    for (int j = 0; j < 25; ++j) a[j] = hit ? at[j] : 0.0f;
  }
  const int mat_id = __float2int_rz(a[24]);
  const bool mat_ok = mat_id >= 0 && mat_id < n_mat;
  const float* mr = mat + (size_t)(mat_ok ? mat_id : 0) * 16;
  auto M = [&](int j) { return mat_ok ? mr[j] : 0.0f; };

  // primary_ref's order: (a + u b) + v c, the squares summed left to right
  float* g = out + p;
  auto put = [&](int c, float val) { g[(size_t)c * r] = val; };
  float nv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(C_POS + k, a[k] + u * a[3 + k] + v * a[6 + k]);
    nv[k] = a[9 + k] + u * a[12 + k] + v * a[15 + k];
  }
  const float nlen = sqrtf(
      gi::clampmin(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2], 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    put(C_NORM + k, nv[k] / nlen);
    put(C_BCOLOR + k, M(1 + k));
  }
  put(C_DIST, hit ? t : __int_as_float(0x7f800000));
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
  put(C_PRIM, hit ? (float)id : -1.0f);
  put_counts<COUNT>(counts, r, p, n);
}

// B13's closest hit, the ray query. Slot i walks ray perm[i] (ray i
// without perm) on the octant loops (bvh.cuh, octant_closest_walk) and
// writes dist, bary, prim (and counts) at that ray's index: dist inf,
// bary 0 and prim -1 on a miss and on lanes with active[p] == 0, which
// are not walked. The caller sorts the rays by the ray key (sort.cu), so
// a warp's lanes run one loop on neighbouring rays. Blocks of 64 threads
// ran as fast, of 256 1.5 % slower, and a persistent grid whose warps
// take groups of 32 sorted rays from a queue within 1 % on bounce rays
// and 2 % slower on camera rays (PERF.md).
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    mt_closest_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const unsigned char* __restrict__ active,
                      const int* __restrict__ perm, BvhRows bvh,
                      float* __restrict__ dist, float* __restrict__ bary,
                      int* __restrict__ prim, int* __restrict__ counts,
                      int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const int p = perm != nullptr ? __ldg(perm + i) : i;
  WalkCount n = {0, 0};
  int id = -1;
  float t = __int_as_float(0x7f800000), u = 0.0f, v = 0.0f;
  if (is_live(active, p))
    t = octant_closest_walk<COUNT>(bvh, load_mt_ray(o, d, p), id, u, v, n);
  dist[p] = t;
  bary[(size_t)p * 2] = u;
  bary[(size_t)p * 2 + 1] = v;
  prim[p] = id;
  put_counts<COUNT>(counts, r, p, n);
}

// B13's any hit, test_occlusion_bvh's segment: d = (y - x) / max(|y - x|,
// 1e-20), origin x + d 1e-5, occluded iff a hit lies at 0 < t <
// |y - x| - 2e-4; the products and sums in the twin's order.
template <bool COUNT, int L>
__global__ void __launch_bounds__(L == TILES ? PIX_BLOCK : BLOCK)
    mt_any_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const unsigned char* __restrict__ active, BvhRows bvh,
                  unsigned char* __restrict__ occluded,
                  int* __restrict__ counts, int width, int pix0, int r) {
  const int p = ray_of<L>(width, pix0, r);
  if (p < 0) return;
  WalkCount n = {0, 0};
  bool blocked = false;
  if (is_live(active, p)) {
    const V3 a = load3(x, p), b = load3(y, p);
    const float sx = b.x - a.x, sy = b.y - a.y, sz = b.z - a.z;
    const float dist = sqrtf(sx * sx + sy * sy + sz * sz);
    const float len = fmaxf(dist, 1e-20f);
    const float dx = sx / len, dy = sy / len, dz = sz / len;
    const MtRay ray = {dx * 1e-5f + a.x, dy * 1e-5f + a.y, dz * 1e-5f + a.z,
                       dx, dy, dz};
    blocked = exact_occluded_walk<COUNT>(bvh, ray, dist - 2e-4f, n);
  }
  occluded[p] = blocked ? 1 : 0;
  put_counts<COUNT>(counts, r, p, n);
}

// B14: the number of nodes each ray's closest-hit walk descends
// (heat_walk: the loop of the ray's octant).
template <bool COUNT, int L>
__global__ void __launch_bounds__(L == TILES ? PIX_BLOCK : BLOCK)
    heatmap_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   BvhRows bvh, int* __restrict__ count,
                   int* __restrict__ counts, int width, int pix0, int r) {
  const int p = ray_of<L>(width, pix0, r);
  if (p < 0) return;
  WalkCount n = {0, 0};
  count[p] = heat_walk<COUNT>(bvh, load_mt_ray(o, d, p), n);
  put_counts<COUNT>(counts, r, p, n);
}

inline int grid(int r) { return (r + BLOCK - 1) / BLOCK; }

inline BvhRows bvh_rows(const float* rows, int size, const float* planes) {
  return {reinterpret_cast<const float4*>(rows), planes, size};
}

}  // namespace

// Every entry point takes the scene's MTBVH as node rows [6B, 8] and B
// (`rows`, `size`) and the plane rows [n_pad, 12]; `counts`, unless null,
// receives int32 [2, R]: the box and plane tests of each ray.

// o, d: float32 [R, 3]. Writes dist [R], bary [R, 2], prim [R].
extern "C" int restir_closest_hit(const float* o, const float* d,
                                  const float* rows, int size,
                                  const float* planes, float* dist,
                                  float* bary, int* prim, int* counts, int r,
                                  void* stream) {
  if (r <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts != nullptr)
    closest_kernel<true><<<grid(r), BLOCK, 0, s>>>(o, d, bvh, dist, bary,
                                                   prim, counts, r);
  else
    closest_kernel<false><<<grid(r), BLOCK, 0, s>>>(o, d, bvh, dist, bary,
                                                    prim, counts, r);
  return (int)cudaGetLastError();
}

// x, y: float32 [R, 3]; active: null or bool [R]. Writes occluded bool [R].
extern "C" int restir_any_hit(const float* x, const float* y,
                              const unsigned char* active, const float* rows,
                              int size, const float* planes,
                              unsigned char* occluded, int* counts, int r,
                              void* stream) {
  if (r <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts != nullptr)
    any_kernel<true><<<grid(r), BLOCK, 0, s>>>(x, y, active, bvh, occluded,
                                               counts, r);
  else
    any_kernel<false><<<grid(r), BLOCK, 0, s>>>(x, y, active, bvh, occluded,
                                                counts, r);
  return (int)cudaGetLastError();
}

// o, d: float32 [R, 3]; active: null or bool [R]; attr [N, 32]; mat
// [n_mat, 16]. Writes the [24, R] pack.
extern "C" int restir_primary_hit(const float* o, const float* d,
                                  const unsigned char* active,
                                  const float* rows, int size,
                                  const float* planes, const float* attr,
                                  const float* mat, int n_mat, float* out,
                                  int* counts, int r, void* stream) {
  if (r <= 0 || size <= 0 || n_mat <= 0) return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts != nullptr)
    primary_kernel<true, false, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, bvh, attr, mat, n_mat, out, counts, 0, 0, r);
  else
    primary_kernel<false, false, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, bvh, attr, mat, n_mat, out, counts, 0, 0, r);
  return (int)cudaGetLastError();
}

// B13 and B14 take the exact walk's node rows [6B, 8] and B (`rows`,
// `size`) and the vertex rows [n_pad, 12]; `counts`, unless null, receives
// int32 [2, R]: the box and triangle tests of each ray.

// o, d: float32 [R, 3]; active: null or bool [R]; perm: null (ray
// order) or int32 [R], the order of the slots. Writes dist [R], bary
// [R, 2], prim [R].
extern "C" int restir_mt_closest_hit(const float* o, const float* d,
                                     const unsigned char* active,
                                     const int* perm, const float* rows,
                                     int size, const float* vrows,
                                     float* dist, float* bary, int* prim,
                                     int* counts, int r, void* stream) {
  if (r <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, vrows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts != nullptr)
    mt_closest_kernel<true><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, perm, bvh, dist, bary, prim, counts, r);
  else
    mt_closest_kernel<false><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, perm, bvh, dist, bary, prim, counts, r);
  return (int)cudaGetLastError();
}

// B13's primary and any hit take the batch's geometry: width > 0 and
// pix0 >= 0 launch 8x4-pixel warps over the band of r rays from global
// pixel pix0 of a frame `width` wide; width 0 launches in ray order.

// x, y: float32 [R, 3]; active: null or bool [R]. Writes occluded bool [R].
extern "C" int restir_mt_any_hit(const float* x, const float* y,
                                 const unsigned char* active,
                                 const float* rows, int size,
                                 const float* vrows,
                                 unsigned char* occluded, int* counts,
                                 int width, int pix0, int r, void* stream) {
  if (r <= 0 || size <= 0 || width < 0 || pix0 < 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, vrows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (width > 0) {
    const dim3 tiles = tile_grid(width, pix0, r);
    if (counts != nullptr)
      mt_any_kernel<true, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          x, y, active, bvh, occluded, counts, width, pix0, r);
    else
      mt_any_kernel<false, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          x, y, active, bvh, occluded, counts, width, pix0, r);
  } else if (counts != nullptr)
    mt_any_kernel<true, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        x, y, active, bvh, occluded, counts, 0, 0, r);
  else
    mt_any_kernel<false, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        x, y, active, bvh, occluded, counts, 0, 0, r);
  return (int)cudaGetLastError();
}

// B12's pack on B13's hit: as restir_primary_hit, on the exact walk.
extern "C" int restir_mt_primary_hit(const float* o, const float* d,
                                     const unsigned char* active,
                                     const float* rows, int size,
                                     const float* vrows, const float* attr,
                                     const float* mat, int n_mat, float* out,
                                     int* counts, int width, int pix0, int r,
                                     void* stream) {
  if (r <= 0 || size <= 0 || n_mat <= 0 || width < 0 || pix0 < 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, vrows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (width > 0) {
    const dim3 tiles = tile_grid(width, pix0, r);
    if (counts != nullptr)
      primary_kernel<true, true, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          o, d, active, bvh, attr, mat, n_mat, out, counts, width, pix0, r);
    else
      primary_kernel<false, true, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          o, d, active, bvh, attr, mat, n_mat, out, counts, width, pix0, r);
  } else if (counts != nullptr)
    primary_kernel<true, true, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, bvh, attr, mat, n_mat, out, counts, 0, 0, r);
  else
    primary_kernel<false, true, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, active, bvh, attr, mat, n_mat, out, counts, 0, 0, r);
  return (int)cudaGetLastError();
}

// o, d: float32 [R, 3] camera rays, with the batch's geometry as B13's
// primary hit takes it. Writes count int32 [R].
extern "C" int restir_bvh_heatmap(const float* o, const float* d,
                                  const float* rows, int size,
                                  const float* vrows, int* count,
                                  int* counts, int width, int pix0, int r,
                                  void* stream) {
  if (r <= 0 || size <= 0 || width < 0 || pix0 < 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = bvh_rows(rows, size, vrows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (width > 0) {
    const dim3 tiles = tile_grid(width, pix0, r);
    if (counts != nullptr)
      heatmap_kernel<true, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          o, d, bvh, count, counts, width, pix0, r);
    else
      heatmap_kernel<false, TILES><<<tiles, PIX_BLOCK, 0, s>>>(
          o, d, bvh, count, counts, width, pix0, r);
  } else if (counts != nullptr)
    heatmap_kernel<true, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, bvh, count, counts, 0, 0, r);
  else
    heatmap_kernel<false, LINEAR><<<grid(r), BLOCK, 0, s>>>(
        o, d, bvh, count, counts, 0, 0, r);
  return (int)cudaGetLastError();
}
