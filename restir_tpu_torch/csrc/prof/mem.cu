// Memory-path probes: table gathers from three places, and a masked
// triplet multiply-add chain over a pixel pack in three layouts; and the
// probes' marker kernel, which delimits timed calls in a trace.
//
// Replaces the TPU probes prof/prof_gather.py:43 (`take_along_axis` on a
// table in VMEM, idx (i * 7919) % K over R = 1920 x 1088, the texture
// fetch candidates) and prof/prof_v3.py:92 (90 rounds of a masked
// triplet FMA / select over an 8-channel pack, scalar vs stacked
// triplets). Plain twins (restir_tpu_torch/prof/kernels.py): index_select
// for the gathers (bit for bit), the same loop in torch for the chains
// (bit for bit: each round is a rounded product then a rounded sum, as
// torch's a * c + b).
//
// Gathers: out[i] = table[idx[i]] with table [K] float32 (K = 1024 or
// 8192, 4 or 32 KB). "shared": the block stages the table in shared
// memory and reads it there; "ldg": read through the read-only cache;
// "tex": a texture object on the linear table (tex1Dfetch). Bound:
// bytes (idx read, out written: 8 bytes a lane); the table stays in L1 /
// L2. The shared form runs a grid of as many 1024-thread blocks as the
// card holds at once with K * 4 bytes each (resident.cuh), no more than
// the lanes need: each block stages the table once with 16-byte loads
// (132 SMs x 2 blocks x 32 KB: 8.4 MB from L2 at K = 8192, where one
// block per 256 lanes read 267 MB), then walks the lanes grid-stride,
// four a thread (one int4 index load, one float4 store), R % 4 lanes in
// a scalar tail.
//
// Chains: a (3), b (3), mask m per pixel; 90 rounds of a = m ? a c_i + b
// : a with c_i = float32(0.5 + i 1e-3). "soa": channel-major [8, R] in,
// [3, R] out (the TPU's layout); "aos": float3 a [R], float3 b [R], m [R]
// in, float3 [R] out; "float4": (a, m) and (b, 0) as two float4 [R], out
// float4 (a, 0) [R]. Every lane runs the rounds and the mask selects once
// at the end; the factors are the multiplies' immediates. Bound:
// operations, 540 a pixel (90 x 3 x (mul, add)), each a whole FP32 lane
// slot (the product and the sum round apart, so no FFMA), beside 40 bytes
// a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "chain_factors.cuh"
#include "resident.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kGatherThreads = 1024;

// The four lanes (x, y, z, w) of one int4 / float4, rotated by `by`
// (0..3) to the left: rot(v, 1) = (y, z, w, x).
template <typename T4>
__device__ __forceinline__ T4 rot(T4 v, int by) {
  if (by & 1) v = T4{v.y, v.z, v.w, v.x};
  if (by & 2) v = T4{v.z, v.w, v.x, v.y};
  return v;
}

// Thread q (grid-stride) gathers lanes 4q .. 4q + 3. Reading them in
// lane order, a warp's 32 reads of one step would be lanes 4q + s of 32
// consecutive q: with the probe's odd index stride c ((i * c) % K, K a
// multiple of 32) that is bank (4 c q + c s) % 32, 4 threads a bank.
// Each step instead reads lane 4q + (s + q / 8) % 4: the 4 threads that
// share 4 c q % 32 (q % 8 equal) then read lanes of 4 different s, whose
// c s % 4 differ, so the warp's 32 reads fall in 32 banks as in a lane
// order of one lane a thread. idx and out are 16-byte aligned (checked
// by the wrapper).
__global__ void __launch_bounds__(kGatherThreads, 2)
    gather_shared_kernel(const float* __restrict__ table, int k,
                         const int* __restrict__ idx, int r,
                         float* __restrict__ out) {
  extern __shared__ float4 tab4[];
  float* tab = reinterpret_cast<float*>(tab4);
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int quads = r >> 2;
  const int stride = gridDim.x * kGatherThreads;
  int q = blockIdx.x * kGatherThreads + threadIdx.x;
  // the first quad's index is in flight while the table stages
  int4 i4 = q < quads ? __ldg(idx4 + q) : make_int4(0, 0, 0, 0);
  // float4 words where the table is 16-byte aligned, then the rest
  const int k4 = (reinterpret_cast<uintptr_t>(table) & 15) ? 0 : k >> 2;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  for (int i = threadIdx.x; i < k4; i += kGatherThreads)
    tab4[i] = __ldg(t4 + i);
  for (int i = 4 * k4 + threadIdx.x; i < k; i += kGatherThreads)
    tab[i] = __ldg(table + i);
  __syncthreads();
  const int turn = (threadIdx.x >> 3) & 3;
  for (; q < quads; q += stride) {
    const int4 next = q + stride < quads ? __ldg(idx4 + q + stride) : i4;
    const int4 j = rot(i4, turn);
    const float4 v = {tab[j.x], tab[j.y], tab[j.z], tab[j.w]};
    out4[q] = rot(v, (4 - turn) & 3);
    i4 = next;
  }
  const int p = 4 * quads + threadIdx.x;  // the tail: r % 4 lanes
  if (blockIdx.x == 0 && p < r) out[p] = tab[__ldg(idx + p)];
}

__global__ void __launch_bounds__(kThreads)
    gather_ldg_kernel(const float* __restrict__ table,
                      const int* __restrict__ idx, int r,
                      float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < r) out[p] = __ldg(table + __ldg(idx + p));
}

__global__ void __launch_bounds__(kThreads)
    gather_tex_kernel(cudaTextureObject_t tex, const int* __restrict__ idx,
                      int r, float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < r) out[p] = tex1Dfetch<float>(tex, __ldg(idx + p));
}

// 90 rounds of a = fl(fl(a c_i) + b) on each component, on every lane;
// the mask selects once, after the last round (a masked-off lane's chain
// is discarded, so the lane keeps a's bits, as in a select per round).
// The factors are immediates of the multiplies (chain_factors.cuh). Each
// round rounds the product and the sum apart, as the twin does: no FMA.
__device__ __forceinline__ float3 chain3(float3 a, float3 b, bool m) {
  float x = a.x, y = a.y, z = a.z;
#pragma unroll
  for (int i = 0; i < restir_prof::kChainRounds; ++i) {
    const float c = restir_prof::chain_factor(i);
    x = __fadd_rn(__fmul_rn(x, c), b.x);
    y = __fadd_rn(__fmul_rn(y, c), b.y);
    z = __fadd_rn(__fmul_rn(z, c), b.z);
  }
  return m ? make_float3(x, y, z) : a;
}

__global__ void __launch_bounds__(kThreads)
    chain_soa_kernel(const float* __restrict__ in, int r,
                     float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= r) return;
  auto at = [&](int ch) { return __ldg(in + (size_t)ch * r + p); };
  const float3 a = chain3(make_float3(at(0), at(1), at(2)),
                          make_float3(at(3), at(4), at(5)), at(6) > 0.5f);
  out[p] = a.x;
  out[(size_t)r + p] = a.y;
  out[2 * (size_t)r + p] = a.z;
}

__global__ void __launch_bounds__(kThreads)
    chain_aos_kernel(const float3* __restrict__ a_in,
                     const float3* __restrict__ b_in,
                     const float* __restrict__ m_in, int r,
                     float3* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= r) return;
  out[p] = chain3(a_in[p], b_in[p], m_in[p] > 0.5f);
}

__global__ void __launch_bounds__(kThreads)
    chain_f4_kernel(const float4* __restrict__ am, const float4* __restrict__ b0,
                    int r, float4* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= r) return;
  const float4 a = __ldg(am + p);
  const float4 b = __ldg(b0 + p);
  const float3 c = chain3(make_float3(a.x, a.y, a.z),
                          make_float3(b.x, b.y, b.z), a.w > 0.5f);
  out[p] = make_float4(c.x, c.y, c.z, 0.0f);
}

}  // namespace

// out [r] = table[idx] (table [k], idx int32 [r] in [0, k)); where 0
// shared memory (k * 4 <= kBlockSmem bytes, else -k * 4 is returned; idx
// and out 16-byte aligned), 1 __ldg, 2 the texture object `tex`
// (restir_prof_tex).
extern "C" int restir_prof_table_gather(const float* table, int k,
                                        const int* idx, int r, int where,
                                        unsigned long long tex, float* out,
                                        void* stream) {
  if (r <= 0 || k <= 0 || where < 0 || where > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (where == 0) {
    const size_t smem = (size_t)k * sizeof(float);
    if (smem > restir_prof::kBlockSmem)
      return -(int)std::min(smem, (size_t)INT_MAX);
    if ((reinterpret_cast<uintptr_t>(idx) |
         reinterpret_cast<uintptr_t>(out)) & 15)
      return (int)cudaErrorInvalidValue;
    static restir_prof::Resident memo;
    int resident = 0;
    const cudaError_t e = restir_prof::resident_blocks(
        gather_shared_kernel, kGatherThreads, smem, memo, &resident);
    if (e != cudaSuccess) return (int)e;
    // no more blocks than quads need (one a thread), at least one (block
    // 0 writes the r % 4 tail)
    const int quads = r / 4;
    const int blocks = std::max(
        1, std::min(resident, (quads + kGatherThreads - 1) / kGatherThreads));
    gather_shared_kernel<<<blocks, kGatherThreads, smem, st>>>(table, k, idx,
                                                               r, out);
    return (int)cudaGetLastError();
  }
  const int grid = (r + kThreads - 1) / kThreads;
  if (where == 1) {
    gather_ldg_kernel<<<grid, kThreads, 0, st>>>(table, idx, r, out);
  } else {
    gather_tex_kernel<<<grid, kThreads, 0, st>>>((cudaTextureObject_t)tex,
                                                 idx, r, out);
  }
  return (int)cudaGetLastError();
}

// A texture object over the linear float32 table [k] (create != 0), or
// destroy *tex (create == 0).
extern "C" int restir_prof_tex(const float* table, int k, int create,
                               unsigned long long* tex) {
  if (!create) return (int)cudaDestroyTextureObject((cudaTextureObject_t)*tex);
  cudaResourceDesc res = {};
  res.resType = cudaResourceTypeLinear;
  res.res.linear.devPtr = const_cast<float*>(table);
  res.res.linear.desc = cudaCreateChannelDesc<float>();
  res.res.linear.sizeInBytes = (size_t)k * sizeof(float);
  cudaTextureDesc td = {};
  td.readMode = cudaReadModeElementType;
  cudaTextureObject_t obj = 0;
  const cudaError_t e = cudaCreateTextureObject(&obj, &res, &td, nullptr);
  *tex = (unsigned long long)obj;
  return (int)e;
}

// The chain over r pixels. layout 0 "soa": in [8, r] -> out [3, r];
// 1 "aos": in = a [r, 3], in2 = b [r, 3], m [r] -> out [r, 3];
// 2 "float4": in = (a, m) [r, 4], in2 = (b, 0) [r, 4] -> out [r, 4].
extern "C" int restir_prof_chain(const float* in, const float* in2,
                                 const float* m, int r, int layout,
                                 float* out, void* stream) {
  if (r <= 0 || layout < 0 || layout > 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (r + kThreads - 1) / kThreads;
  if (layout == 0)
    chain_soa_kernel<<<blocks, kThreads, 0, st>>>(in, r, out);
  else if (layout == 1)
    chain_aos_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float3*>(in),
        reinterpret_cast<const float3*>(in2), m, r,
        reinterpret_cast<float3*>(out));
  else
    chain_f4_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(in),
        reinterpret_cast<const float4*>(in2), r,
        reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

namespace {

// An empty kernel whose launches delimit the calls of a timed run in a
// profiler trace (restir_tpu_torch/prof/_timing.py): the kernels between
// two marks on one stream are one call's.
__global__ void probe_mark_kernel() {}

}  // namespace

extern "C" int restir_prof_mark(void* stream) {
  probe_mark_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
