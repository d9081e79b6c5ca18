// Kernel B10: the general path's ReSTIR DI candidate stage. K draws from
// the per-pixel CDF over all area lights, a single-draw winner, and the
// winner's shadow ray through the scene's MTBVH.
//
// Replaces restir_tpu/ops/pallas/ris_kernel.py::_ris_kernel
// (ris_cdf_pallas). The TPU kernel builds the [L, B] target matrix and its
// CDF with bf16-split matmuls, then tests the winner's ray against every
// triangle; here one thread runs B1's RIS core (di_core.cuh's ris_select,
// the same per-light target, sequential CDF, K candidates and winner
// pick) on a Surface built from the [14, R] input pack (pos, normal, wo,
// material type / metallic / roughness, shade, primitive), then walks the
// stackless MTBVH (bvh.cuh's occluded_walk on BvhRows) with the TPU
// kernel's contract: origin pushed 1e-5 along wi, a hit counts at
// 0 < t < dist (1 - 1e-3) - 1e-4 on a triangle other than the pixel's own
// (shadow_ray, shadow_limit: B7's ray). The leaf test is plane_hit, the
// twin's, so the walk returns the every-row loop's occlusion. The RNG is
// pcg4d on the global pixel index pix0 + p (pix0: the first pixel of a
// row band, 0 for the whole frame), counters CTR_RIS + j, salt
// SALT_RESTIR; the packs are read and written at p.
//
// Bound: FMA throughput of the RIS core (2 x l_pad light targets, ~32
// FLOP each, and K candidates, ~120 FLOP each, per pixel), then the
// latency of the shadow walk's dependent loads, as B7. Only the light
// tables (l_pad x 16 floats, twice) stay in shared memory; the walk reads
// node and plane rows from global memory through the read-only cache.
// Lanes whose winner carries no weight do not walk. The COUNT build also
// returns each walk's box and plane tests.
#include "bvh.cuh"
#include "di_core.cuh"
#if defined(PROBE_WALK)
#include "prof/walk_probe.cuh"  // stage probes (restir_tpu_torch/prof)
#endif

using namespace restir;

namespace {

constexpr int BLOCK = 256;

// input / output pack channels (ris_kernel.py:37-41)
enum {
  I_POS = 0, I_NORM = 3, I_WO = 6, I_MTYPE = 9, I_METAL = 10, I_ROUGH = 11,
  I_SHADE = 12, I_PRIM = 13
};
enum { O_LI = 0, O_WI = 3, O_DIST = 6, O_W = 7, O_M = 8, O_PAD = 9 };

template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    ris_cdf_kernel(const float* __restrict__ in, uint32_t looper,
                   uint32_t pix0, const float* __restrict__ lights_g,
                   const float* __restrict__ psi_g, int l_pad, int n_area,
                   BvhRows bvh, float* __restrict__ out,
                   int* __restrict__ stats, int r, int single_sided, int k,
                   int has_met) {
  extern __shared__ float4 smem4[];
  float* psi = reinterpret_cast<float*>(smem4);
  float* lights = psi + l_pad * 16;
  for (int i = threadIdx.x; i < l_pad * 16; i += blockDim.x) {
    psi[i] = psi_g[i];
    lights[i] = lights_g[i];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  const float* g = in + p;
  auto at = [&](int ch) { return g[(size_t)ch * r]; };
  Surface s = {};
  s.px = at(I_POS);
  s.py = at(I_POS + 1);
  s.pz = at(I_POS + 2);
  s.nx = at(I_NORM);
  s.ny = at(I_NORM + 1);
  s.nz = at(I_NORM + 2);
  s.dx = -at(I_WO);  // the Surface carries the ray direction, -wo
  s.dy = -at(I_WO + 1);
  s.dz = -at(I_WO + 2);
  s.mtype = at(I_MTYPE);
  s.metallic = at(I_METAL);
  s.roughness = at(I_ROUGH);
  s.shade = at(I_SHADE) > 0.5f;
  s.prim = __float2int_rz(at(I_PRIM));
  const Candidate c = ris_select<false>(psi, lights, l_pad, n_area,
                                        pix0 + (uint32_t)p, looper, k,
                                        single_sided, has_met, s);

  WalkCount n = {0, 0};
#if defined(PROBE_WALK)
  if (PROBE_WALK == 2) n = {stats[p], stats[(size_t)r + p]};
  const bool blocked =
      c.r_weight > 0.0f &&
      probe_occluded_walk<PROBE_WALK>(bvh, shadow_ray(s, c),
                                      shadow_limit(c), s.prim, n);
#else
  const bool blocked =
      c.r_weight > 0.0f && occluded_walk<COUNT>(bvh, shadow_ray(s, c),
                                                shadow_limit(c), s.prim, n);
#endif
  float* o = out + p;
  auto put = [&](int ch, float val) { o[(size_t)ch * r] = val; };
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    put(O_LI + i, c.li[i]);
    put(O_WI + i, c.wi[i]);
  }
  put(O_DIST, c.dist);
  put(O_W, blocked ? 0.0f : c.r_weight);
  put(O_M, s.shade ? (float)k : 0.0f);
  put(O_PAD, 0.0f);
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT>
int launch_ris_cdf(const float* in, uint32_t looper, uint32_t pix0,
                   const float* lights,
                   const float* psi, int l_pad, int n_area,
                   const BvhRows& bvh, float* out, int* stats, int r,
                   int single_sided, int k, int has_met,
                   cudaStream_t stream) {
  const size_t smem = (size_t)l_pad * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ris_cdf_kernel<COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ris_cdf_kernel<COUNT><<<(r + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(
      in, looper, pix0, lights, psi, l_pad, n_area, bvh, out, stats, r,
      single_sided, k, has_met);
  return (int)cudaGetLastError();
}

}  // namespace

// in: float32 [14, R]; lights / psi: [l_pad, 16] (tables.light_tables);
// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// scene's MTBVH (ops/kernels/tables.py). Writes out [10, R]: li (3), wi
// (3), dist, weight (zero when the winner is occluded), M, 0. stats:
// null, or int32 [2, R] that receives each shadow walk's box and plane
// test counts. pix0: the global index of pixel 0 of the pack, the key of
// its draws.
extern "C" int restir_ris_cdf(const float* in, uint32_t looper,
                              uint32_t pix0, const float* lights,
                              const float* psi,
                              int l_pad, int n_area, const float* rows,
                              int size, const float* planes, float* out,
                              int* stats, int r, int single_sided, int k,
                              int has_met, void* stream) {
  if (k < 1 || k > MAX_K || r <= 0 || l_pad <= 0 || size <= 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream;
  if (stats)
    return launch_ris_cdf<true>(in, looper, pix0, lights, psi, l_pad, n_area,
                                bvh, out, stats, r, single_sided, k, has_met,
                                st);
  return launch_ris_cdf<false>(in, looper, pix0, lights, psi, l_pad, n_area,
                               bvh, out, stats, r, single_sided, k, has_met,
                               st);
}
