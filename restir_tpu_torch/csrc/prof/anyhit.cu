// The brute-force any hit of a ray batch against every padded triangle
// plane row, in two forms: a per-lane FP32 FMA loop, and tensor-core
// tiles (mma.sync m16n8k8 TF32 on operands split into TF32 pieces:
// 3xTF32, hi / lo, 3 products; or 6xTF32, hi / mid / lo, 6 products).
//
// Replaces the TPU probe prof/prof_fma.py: `_mxu_kernel` (:30, launched
// at :116; the six plane dots as bf16-split MXU products, dot_f32x3) and
// `_fma_kernel` (:63, launched at :139; the same test per lane on the
// VPU). Plain twins (restir_tpu_torch/prof/kernels.py): the FMA form's is
// intersect_bf's plane test in float32, the tensor-core forms' split
// their operands into TF32 pieces first. The unit-plane dots cancel
// large terms (|o| ~ 10-30, results ~ 1e-5 near a surface), so 3xTF32's
// 22 bits of each operand miss the reference's primitive gate (mismatch
// <= 0.2 %) on shadow segments; 6xTF32 (33 bits) holds it.
//
// The test of ray (o, d, limit) against triangle j's unit-plane rows xu,
// xv, xw (ops/kernels/tables.py, [n_pad, 12]; zero rows for padding):
//   oo = x . (o, 1), dd = x . (d, 0) for x in xu, xv, xw;
//   t = -oo_w / dd_w, u = oo_u + t dd_u, v = oo_v + t dd_v;
//   blocked = |dd_w| >= 1e-12, t > 0, u >= 0, v >= 0, u + v <= 1, t < limit.
// Every lane tests every row (no early exit, as the TPU kernels), so the
// two forms do the same work.
//
// Bound: operations. Per (ray, row) pair the six dots are 21 FP32 FMAs
// and the epilogue about 12 FP32 operations and a division. The MMA form
// moves the dots to the tensor cores (3 or 6 MMAs per plane) and keeps
// the epilogue on the FP32 pipes, whose issue rate then binds.
// Rows are staged once per block in shared memory (512 rows: 24 KB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool blocked(float oou, float oov, float oow,
                                        float ddu, float ddv, float ddw,
                                        float limit) {
  const bool nondeg = fabsf(ddw) >= 1e-12f;
  const float t = -oow / (nondeg ? ddw : 1.0f);
  const float u = oou + t * ddu, v = oov + t * ddv;
  return nondeg && t > 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t < limit;
}

// rays [8, r] channel-major: o (3), d (3), limit, pad.
__global__ void __launch_bounds__(kThreads)
    anyhit_fma_kernel(const float* __restrict__ rays,
                      const float* __restrict__ planes, int n_pad, int r,
                      uint8_t* __restrict__ occ) {
  extern __shared__ float4 rows4[];
  const float4* g4 = reinterpret_cast<const float4*>(planes);
  for (int i = threadIdx.x; i < 3 * n_pad; i += kThreads) rows4[i] = g4[i];
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= r) return;
  const float ox = rays[p], oy = rays[(size_t)r + p],
              oz = rays[2 * (size_t)r + p];
  const float dx = rays[3 * (size_t)r + p], dy = rays[4 * (size_t)r + p],
              dz = rays[5 * (size_t)r + p];
  const float limit = rays[6 * (size_t)r + p];
  bool hit = false;
  for (int j = 0; j < n_pad; ++j) {
    const float4 a = rows4[3 * j], b = rows4[3 * j + 1], c = rows4[3 * j + 2];
    const float oou = a.x * ox + a.y * oy + a.z * oz + a.w;
    const float oov = b.x * ox + b.y * oy + b.z * oz + b.w;
    const float oow = c.x * ox + c.y * oy + c.z * oz + c.w;
    const float ddu = a.x * dx + a.y * dy + a.z * dz;
    const float ddv = b.x * dx + b.y * dy + b.z * dz;
    const float ddw = c.x * dx + c.y * dy + c.z * dz;
    hit |= blocked(oou, oov, oow, ddu, ddv, ddw, limit);
  }
  occ[p] = hit ? 1 : 0;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// D += A B for one m16n8k8 TF32 tile (A row-major 16 x 8, B column-major
// 8 x 8; fragments as PTX's mma.m16n8k8 .tf32 layout).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp tests 16 rays (the tile's rows) against 4 triangles per step:
// A = the rays' (o, 1, d, 0), K = 8; B's column 2q is triangle q's plane
// row over K = 0..3 (the dot with (o, 1)), column 2q + 1 the same row's
// xyz over K = 4..6 (the dot with (d, 0)). Lane (g, t) (g = lane / 4, t =
// lane % 4) then holds oo and dd of triangle t for rays g and g + 8, per
// plane, and runs the epilogue on those two pairs; the 4 lanes of a quad
// OR their flags at the end. x = hi + mid + lo, each TF32 (hi = tf32(x),
// mid = tf32(x - hi), lo = tf32(x - hi - mid)); SPLIT 3: A B ~ A_mid B_hi
// + A_hi B_mid + A_hi B_hi; SPLIT 6: also + A_lo B_hi + A_hi B_lo + A_mid
// B_mid, first; products accumulate in FP32, smallest first.
template <int SPLIT>
__global__ void __launch_bounds__(kThreads)
    anyhit_mma_kernel(const float* __restrict__ rays,
                      const float* __restrict__ planes, int n_pad, int r,
                      uint8_t* __restrict__ occ) {
  extern __shared__ float4 rows4[];
  const float4* g4 = reinterpret_cast<const float4*>(planes);
  for (int i = threadIdx.x; i < 3 * n_pad; i += kThreads) rows4[i] = g4[i];
  __syncthreads();
  const float* rows = reinterpret_cast<const float*>(rows4);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = (blockIdx.x * kThreads + threadIdx.x) >> 5;  // 16 rays
  const int p0 = tile * 16 + g, p1 = p0 + 8;
  auto ray = [&](int p, int ch) {
    return p < r ? rays[(size_t)ch * r + p] : 0.0f;
  };
  // A fragments: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
  // a3 = A[g + 8][t + 4]
  const float av[4] = {t < 3 ? ray(p0, t) : 1.0f, t < 3 ? ray(p1, t) : 1.0f,
                       t < 3 ? ray(p0, 3 + t) : 0.0f,
                       t < 3 ? ray(p1, 3 + t) : 0.0f};
  uint32_t a_hi[4], a_mid[4], a_lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_hi[i] = tf32(av[i]);
    const float rest = av[i] - __uint_as_float(a_hi[i]);
    a_mid[i] = tf32(rest);
    a_lo[i] = tf32(rest - __uint_as_float(a_mid[i]));
  }
  const float lim0 = p0 < r ? rays[6 * (size_t)r + p0] : -1.0f;
  const float lim1 = p1 < r ? rays[6 * (size_t)r + p1] : -1.0f;
  // B fragments of column n = g: triangle q = g / 2, o-dot (g even) or
  // d-dot (g odd); b0 = B[t][g], b1 = B[t + 4][g].
  const int q = g >> 1;
  const bool odot = (g & 1) == 0;
  bool hit0 = false, hit1 = false;
  for (int j0 = 0; j0 < n_pad; j0 += 4) {
    float oo[3][2], dd[3][2];
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const float* row = rows + (size_t)(j0 + q) * 12 + 4 * pl;
      const float b0 = odot ? row[t] : 0.0f;
      const float b1 = (!odot && t < 3) ? row[t] : 0.0f;
      const uint32_t bh[2] = {tf32(b0), tf32(b1)};
      const float r0 = b0 - __uint_as_float(bh[0]),
                  r1 = b1 - __uint_as_float(bh[1]);
      const uint32_t bm[2] = {tf32(r0), tf32(r1)};
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (SPLIT == 6) {
        const uint32_t bl[2] = {tf32(r0 - __uint_as_float(bm[0])),
                                tf32(r1 - __uint_as_float(bm[1]))};
        mma_tf32(acc, a_lo, bh);
        mma_tf32(acc, a_hi, bl);
        mma_tf32(acc, a_mid, bm);
      }
      mma_tf32(acc, a_mid, bh);
      mma_tf32(acc, a_hi, bm);
      mma_tf32(acc, a_hi, bh);
      // acc: (ray g, col 2t) (ray g, col 2t + 1) (ray g + 8, 2t) (g + 8,
      // 2t + 1): triangle j0 + t's o-dot and d-dot for rays g and g + 8
      oo[pl][0] = acc[0];
      dd[pl][0] = acc[1];
      oo[pl][1] = acc[2];
      dd[pl][1] = acc[3];
    }
    hit0 |= blocked(oo[0][0], oo[1][0], oo[2][0], dd[0][0], dd[1][0],
                    dd[2][0], lim0);
    hit1 |= blocked(oo[0][1], oo[1][1], oo[2][1], dd[0][1], dd[1][1],
                    dd[2][1], lim1);
  }
  unsigned h0 = hit0, h1 = hit1;
  h0 |= __shfl_xor_sync(0xffffffffu, h0, 1);
  h0 |= __shfl_xor_sync(0xffffffffu, h0, 2);
  h1 |= __shfl_xor_sync(0xffffffffu, h1, 1);
  h1 |= __shfl_xor_sync(0xffffffffu, h1, 2);
  if (t == 0) {
    if (p0 < r) occ[p0] = h0 ? 1 : 0;
    if (p1 < r) occ[p1] = h1 ? 1 : 0;
  }
}

template <int SPLIT>
int launch_mma(const float* rays, const float* planes, int n_pad, int r,
               uint8_t* occ, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anyhit_mma_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_block = kThreads / 32 * 16;  // rays per block
  anyhit_mma_kernel<SPLIT><<<(r + per_block - 1) / per_block, kThreads, smem,
                             st>>>(rays, planes, n_pad, r, occ);
  return (int)cudaGetLastError();
}

}  // namespace

// occ uint8 [r]: 1 where ray p (rays [8, r]: o, d, limit, pad) hits a
// row of planes [n_pad, 12] at 0 < t < limit. form 0: the FP32 FMA loop;
// form 1: mma.sync 3xTF32 tiles, form 2: 6xTF32 (n_pad % 4 == 0).
extern "C" int restir_prof_anyhit(const float* rays, const float* planes,
                                  int n_pad, int r, int form, uint8_t* occ,
                                  void* stream) {
  if (r <= 0 || n_pad <= 0 || n_pad % 4 != 0 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_pad * 12 * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          anyhit_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    anyhit_fma_kernel<<<(r + kThreads - 1) / kThreads, kThreads, smem, st>>>(
        rays, planes, n_pad, r, occ);
    return (int)cudaGetLastError();
  }
  return form == 1 ? launch_mma<3>(rays, planes, n_pad, r, occ, smem, st)
                   : launch_mma<6>(rays, planes, n_pad, r, occ, smem, st);
}
