// The brute-force any hit of a ray batch against every padded triangle
// plane row, in two forms: a per-lane FP32 FMA loop, and tensor-core
// tiles (wgmma TF32 on operands split into TF32 pieces: 3xTF32, hi /
// mid, 3 products; or 6xTF32, hi / mid / lo, 6 products).
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
// and the epilogue about 12 FP32 operations and a division. The
// tensor-core forms move the dots to the tensor cores and keep the
// epilogue on the FP32 pipes (`anyhit_mma_kernel` says how). The FP32
// form (`anyhit_fma_kernel`) holds two rays a lane on a persistent grid
// fed from a queue of ray groups.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "resident.cuh"

namespace {

constexpr int kThreads = 256;

// Rays a lane of the FP32 any hit; -DPROBE_ANYHIT_RAYS=1 builds the
// one-ray-a-lane reference (`_build.VARIANTS["prof_ray1"]`), whose flags
// the two-ray build must equal bit for bit.
#ifndef PROBE_ANYHIT_RAYS
#define PROBE_ANYHIT_RAYS 2
#endif
constexpr int kRays = PROBE_ANYHIT_RAYS;
constexpr int kUnroll = 4;     // rows a step (n_pad % 4 == 0)
constexpr int kFmaBlocks = 4;  // blocks an SM: at most 64 registers

// The IEEE division and nvcc's contraction of `oou + t * ddu` into one
// FFMA, as in the one-ray form before it. A degenerate pair divides 1 by
// 1 (its flag is false whatever t is): the -0 / 1 that a zero row padding
// the table gives would take the division's slow path. The terms are
// ANDed, not short-circuited, so the test has no branch of its own.
__device__ __forceinline__ bool blocked(float oou, float oov, float oow,
                                        float ddu, float ddv, float ddw,
                                        float limit) {
  const bool nondeg = fabsf(ddw) >= 1e-12f;
  const float t = (nondeg ? -oow : 1.0f) / (nondeg ? ddw : 1.0f);
  const float u = oou + t * ddu, v = oov + t * ddv;
  return nondeg & (t > 0.0f) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
         (t < limit);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, limit;
};

// Ray p of rays [8, r] channel-major (o (3), d (3), limit, pad); past r
// a ray whose limit -1 hits nothing.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int r, int p) {
  if (p >= r) return Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1.0f};
  auto at = [&](int ch) { return __ldg(rays + (size_t)ch * r + p); };
  return Ray{at(0), at(1), at(2), at(3), at(4), at(5), at(6)};
}

// The six dots, summed left to right as written (an FMUL, FFMAs, then
// the w term's FADD), and the test, of ray q against one triangle's plane
// rows xu, xv, xw.
__device__ __forceinline__ bool pair(const Ray& q, float4 a, float4 b,
                                     float4 c) {
  const float oou = a.x * q.ox + a.y * q.oy + a.z * q.oz + a.w;
  const float oov = b.x * q.ox + b.y * q.oy + b.z * q.oz + b.w;
  const float oow = c.x * q.ox + c.y * q.oy + c.z * q.oz + c.w;
  const float ddu = a.x * q.dx + a.y * q.dy + a.z * q.dz;
  const float ddv = b.x * q.dx + b.y * q.dy + b.z * q.dz;
  const float ddw = c.x * q.dx + c.y * q.dy + c.z * q.dz;
  return blocked(oou, oov, oow, ddu, ddv, ddw, q.limit);
}

// The FP32 any hit on a persistent grid: a block stages the rows once in
// shared memory (512 rows: 24 KB), then each warp takes groups of 32
// kRays rays from a queue (one atomicAdd a group on `next`, zeroed
// before the launch), kRays rays a lane (p, p + 32, ...), so that a row's
// three LDS.128 serve them all and their tests interleave; a warp whose
// sub-partition runs ahead takes more groups, so the SMs end together.
__global__ void __launch_bounds__(kThreads, kFmaBlocks)
    anyhit_fma_kernel(const float* __restrict__ rays,
                      const float* __restrict__ planes, int n_pad, int r,
                      uint8_t* __restrict__ occ,
                      unsigned int* __restrict__ next) {
  extern __shared__ float4 rows4[];
  const float4* g4 = reinterpret_cast<const float4*>(planes);
  for (int i = threadIdx.x; i < 3 * n_pad; i += kThreads)
    rows4[i] = __ldg(g4 + i);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int groups = (r + 32 * kRays - 1) / (32 * kRays);
  for (;;) {
    int g = 0;
    if (lane == 0) g = (int)atomicAdd(next, 1u);
    g = __shfl_sync(0xffffffffu, g, 0);
    if (g >= groups) return;
    const int p = g * 32 * kRays + lane;
    Ray q[kRays];
    bool hit[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      q[k] = load_ray(rays, r, p + 32 * k);
      hit[k] = false;
    }
    for (int j = 0; j < 3 * n_pad; j += 3 * kUnroll) {
#pragma unroll
      for (int s = 0; s < 3 * kUnroll; s += 3) {
        const float4 a = rows4[j + s], b = rows4[j + s + 1],
                     c = rows4[j + s + 2];
#pragma unroll
        for (int k = 0; k < kRays; ++k) hit[k] |= pair(q[k], a, b, c);
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      if (p + 32 * k < r) occ[p + 32 * k] = hit[k] ? 1 : 0;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// The test of `blocked` with t from the reciprocal (rcp.approx, one MUFU
// op) in place of the IEEE division: t moves by an ulp or two, which
// can flip a ray whose hit lies on an edge, or at t = 0 or the limit.
__device__ __forceinline__ bool blocked_rcp(float oou, float oov, float oow,
                                            float ddu, float ddv, float ddw,
                                            float limit) {
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(ddw));
  const float t = -oow * inv;
  const float u = fmaf(t, ddu, oou), v = fmaf(t, ddv, oov);
  return (fabsf(ddw) >= 1e-12f) & (t > 0.0f) & (u >= 0.0f) & (v >= 0.0f) &
         (u + v <= 1.0f) & (t < limit);
}

// A wgmma shared-memory matrix descriptor without swizzle: start address,
// the byte offset between the two 8 x 16-byte core matrices of K
// (leading) and between core matrices of N (stride), each in 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of the accumulators above the
// wait (the wgmma writes them asynchronously).
__device__ __forceinline__ void pin(float (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 96, f32) = A (64 x 8 TF32, registers) B (8 x 96 TF32, shared
// memory at descriptor b) [+ D where acc]. A's fragments are mma.sync
// m16n8k8's, warp w of the warpgroup holding rows 16 w .. 16 w + 15; D's
// are m16n8's per 8 columns: d[4 c + e] is column block c's.
__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

constexpr int kMmaThreads = 128;  // one warpgroup: 64 rays a task
constexpr int kBlocks = 4;        // 8-triangle blocks a product: N = 96
constexpr int kCore = 128;        // bytes of a core matrix: 8 x 16
constexpr int kGroup = 3 * kBlocks * kCore;  // one piece of 32 triangles

// TF32 pieces of the planes in shared memory: hi / mid (3x), lo / hi /
// mid (6x)
template <int SPLIT>
constexpr int kPieces = SPLIT == 3 ? 2 : 3;

// The tensor-core any hit. A block is one warpgroup; it takes 64 rays
// at a time (tasks grid-stride over a persistent grid) and walks the
// rows 32 triangles at a time. For plane x of xu, xv, xw the products
// are oo = A_o B_x (A_o: the rays' (o, 1)) and dd = A_d B_x (A_d: (d,
// 0)), K = the plane row's x, y, z, w, so no K slot carries a zero but
// dd's w; one wgmma m64n96k8 takes all three planes of 32 triangles
// (column 8 (4 x + b) + n: triangle 8 b + n's plane x). Each operand is
// split into TF32 pieces, x = hi + mid + lo (hi = tf32(x), mid = tf32(x
// - hi), lo = tf32(x - hi - mid)), and each k8 product folds two pieces
// into K, A = (a_hi, a_mid) against B = (b_hi, b_hi) giving a_hi b_hi +
// a_mid b_hi:
//   3xTF32: (a_hi, a_mid; b_mid, 0), then (a_hi, a_mid; b_hi, b_hi);
//   6xTF32: (a_hi, a_lo; b_lo, b_hi), (a_hi, a_mid; b_mid, b_mid), then
//   (a_hi, a_mid; b_hi, b_hi);
// accumulating in FP32 on the tensor cores, smallest first. B's K halves
// are core matrices a descriptor's leading offset apart: 0 repeats a
// piece, a zero core supplies 3xTF32's 0. The planes are split once, as
// the block stages them in shared memory, each piece as the plane rows
// themselves (a core matrix is 8 rows of 16 bytes), so a step does no
// conversion; the A pieces are split once a task. Then the block waits
// for the products and runs the test on 16 pairs a thread (2 rays x 8
// triangles; `blocked_rcp`): the tensor cores' work and the FP32 test
// overlap across the 3 blocks an SM holds, not inside one (a second
// accumulator set in flight made ptxas serialize the wgmmas).
template <int SPLIT>
__global__ void __launch_bounds__(kMmaThreads, 3)
    anyhit_mma_kernel(const float* __restrict__ rays,
                      const float* __restrict__ planes, int n_pad, int r,
                      uint8_t* __restrict__ occ) {
  constexpr int NP = kPieces<SPLIT>;
  constexpr int LO = 0, HI = SPLIT == 3 ? 0 : 1, MID = HI + 1;
  extern __shared__ __align__(128) float sm[];
  const int groups = (n_pad + 31) / 32;
  // piece p of plane x, triangles 32 s + 8 b .. + 7: the core matrix at
  // float ((s NP + p) 3 + x) kBlocks + b) 32; row n, component c
  for (int e = threadIdx.x; e < groups * 32 * 3; e += kMmaThreads) {
    const int tri = e / 3, x = e % 3, s = tri >> 5, b = (tri >> 3) & 3;
    float* row = sm + (((s * NP) * 3 + x) * kBlocks + b) * 32 + (tri & 7) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v =
          tri < n_pad ? __ldg(planes + tri * 12 + 4 * x + c) : 0.0f;
      const float hi = __uint_as_float(tf32(v));
      const float rest = v - hi;
      const float mid = __uint_as_float(tf32(rest));
      row[HI * kGroup / 4 + c] = hi;
      row[MID * kGroup / 4 + c] = mid;
      if constexpr (SPLIT == 6)
        row[LO * kGroup / 4 + c] = __uint_as_float(tf32(rest - mid));
    }
  }
  const int zero = groups * NP * kGroup;  // bytes: 3xTF32's zero cores
  if constexpr (SPLIT == 3) {
    for (int i = threadIdx.x; i < kGroup / 4; i += kMmaThreads)
      sm[zero / 4 + i] = 0.0f;
  }
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int task = blockIdx.x; task < (r + 63) / 64; task += gridDim.x) {
    // A pieces of rays g and g + 8 of warp w's 16, component t: (hi, hi,
    // mid, mid) and (6xTF32) (hi, hi, lo, lo), for (o, 1) and (d, 0)
    uint32_t ao[4], ad[4], aol[4], adl[4];
    float lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = task * 64 + 16 * w + 8 * h + g;
      const bool in = p < r;
      const float o = t < 3 ? (in ? rays[(size_t)t * r + p] : 0.0f) : 1.0f;
      const float d = t < 3 && in ? rays[(size_t)(3 + t) * r + p] : 0.0f;
      lim[h] = in ? rays[6 * (size_t)r + p] : -1.0f;
      const uint32_t oh = tf32(o), dh = tf32(d);
      const float orest = o - __uint_as_float(oh),
                  drest = d - __uint_as_float(dh);
      const uint32_t om = tf32(orest), dm = tf32(drest);
      ao[h] = aol[h] = oh;
      ad[h] = adl[h] = dh;
      ao[2 + h] = om;
      ad[2 + h] = dm;
      aol[2 + h] = tf32(orest - __uint_as_float(om));
      adl[2 + h] = tf32(drest - __uint_as_float(dm));
    }
    bool hit[2] = {false, false};
    for (int s = 0; s < groups; ++s) {
      float oo[48], dd[48];
      const uint32_t at = base + (uint32_t)(s * NP * kGroup);
      wg_fence();
      if constexpr (SPLIT == 6) {
        const uint64_t lohi = smem_desc(at + LO * kGroup, kGroup, kCore);
        wgmma_n96(oo, aol, lohi, 0);
        wgmma_n96(dd, adl, lohi, 0);
        const uint64_t mm = smem_desc(at + MID * kGroup, 0, kCore);
        wgmma_n96(oo, ao, mm, 1);
        wgmma_n96(dd, ad, mm, 1);
      } else {
        const uint32_t mid = at + MID * kGroup;
        const uint64_t m0 = smem_desc(mid, base + zero - mid, kCore);
        wgmma_n96(oo, ao, m0, 0);
        wgmma_n96(dd, ad, m0, 0);
      }
      const uint64_t hh = smem_desc(at + HI * kGroup, 0, kCore);
      wgmma_n96(oo, ao, hh, 1);
      wgmma_n96(dd, ad, hh, 1);
      wg_commit_wait();
      pin(oo);
      pin(dd);
      // column block 4 x + b holds plane x of triangles 32 s + 8 b + 2t,
      // + 2t + 1 for ray g (e = 0, 1) and ray g + 8 (e = 2, 3)
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 4 * b + e, v = u + 4 * kBlocks, x = v + 4 * kBlocks;
          hit[e >> 1] |= blocked_rcp(oo[u], oo[v], oo[x], dd[u], dd[v],
                                     dd[x], lim[e >> 1]);
        }
      }
    }
    // lane l < 16 writes ray 16 w + l of the task: rows g = l % 8 (l < 8)
    // or g + 8, whose four lanes 4g .. 4g + 3 tested disjoint triangles
    uint8_t mine = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned votes = __ballot_sync(0xffffffffu, hit[h]);
      if (lane >> 3 == h) mine = ((votes >> (4 * (lane & 7))) & 0xFu) != 0;
    }
    const int p = task * 64 + 16 * w + lane;
    if (lane < 16 && p < r) occ[p] = mine;
  }
}

template <int SPLIT>
int launch_mma(const float* rays, const float* planes, int n_pad, int r,
               uint8_t* occ, cudaStream_t st) {
  const size_t smem = ((size_t)(n_pad + 31) / 32 * kPieces<SPLIT> +
                       (SPLIT == 3 ? 1 : 0)) * kGroup;
  if (smem > restir_prof::kBlockSmem)
    return -(int)std::min(smem, (size_t)INT_MAX);
  static restir_prof::Resident memo;
  int resident = 0;
  const cudaError_t e = restir_prof::resident_blocks(
      anyhit_mma_kernel<SPLIT>, kMmaThreads, smem, memo, &resident);
  if (e != cudaSuccess) return (int)e;
  const int blocks = std::min(resident, (r + 63) / 64);
  anyhit_mma_kernel<SPLIT><<<blocks, kMmaThreads, smem, st>>>(rays, planes,
                                                              n_pad, r, occ);
  return (int)cudaGetLastError();
}

}  // namespace

// occ uint8 [r]: 1 where ray p (rays [8, r]: o, d, limit, pad) hits a
// row of planes [n_pad, 12] at 0 < t < limit. form 0: the FP32 FMA loop;
// form 1: wgmma 3xTF32 tiles, form 2: 6xTF32 (n_pad % 4 == 0; the rows,
// or the tensor-core forms' pieces, in at most kBlockSmem bytes of shared
// memory: n_pad <= 4,840 for FP32, 2,400 for 3xTF32, 1,600 for 6xTF32;
// over it, -bytes needed).
extern "C" int restir_prof_anyhit(const float* rays, const float* planes,
                                  int n_pad, int r, int form, uint8_t* occ,
                                  void* stream) {
  if (r <= 0 || n_pad <= 0 || n_pad % 4 != 0 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (form == 0) {
    const size_t smem = (size_t)n_pad * 12 * sizeof(float);
    if (smem > restir_prof::kBlockSmem)
      return -(int)std::min(smem, (size_t)INT_MAX);
    static restir_prof::Resident memo;
    int resident = 0;
    cudaError_t e = restir_prof::resident_blocks(anyhit_fma_kernel, kThreads,
                                                 smem, memo, &resident);
    if (e != cudaSuccess) return (int)e;
    // no more blocks than the groups give each warp one
    const long long per_block = 32LL * kRays * (kThreads / 32);
    const int blocks = (int)std::min<long long>(
        resident, (r + per_block - 1) / per_block);
    // the queue's counter: this launch's own, so launches on two streams
    // do not share it
    unsigned int* next = nullptr;
    e = cudaMallocAsync(reinterpret_cast<void**>(&next), sizeof(unsigned int),
                        st);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(next, 0, sizeof(unsigned int), st);
    if (e == cudaSuccess) {
      anyhit_fma_kernel<<<blocks, kThreads, smem, st>>>(rays, planes, n_pad,
                                                        r, occ, next);
      e = cudaGetLastError();
    }
    const cudaError_t f = cudaFreeAsync(next, st);
    return (int)(e != cudaSuccess ? e : f);
  }
  return form == 1 ? launch_mma<3>(rays, planes, n_pad, r, occ, st)
                   : launch_mma<6>(rays, planes, n_pad, r, occ, st);
}
