// Kernel B10: the general path's ReSTIR DI candidate stage. K draws from
// the per-pixel CDF over all area lights, a single-draw winner, and the
// winner's shadow ray against every triangle.
//
// Replaces restir_tpu/ops/pallas/ris_kernel.py::_ris_kernel
// (ris_cdf_pallas). The TPU kernel builds the [L, B] target matrix and its
// CDF with bf16-split matmuls; here one thread runs B1's RIS core
// (di_core.cuh's ris_select, the same per-light target, sequential CDF,
// K candidates and winner pick) on a Surface built from the [14, R] input
// pack (pos, normal, wo, material type / metallic / roughness, shade,
// primitive), then tests the winner's shadow ray against every plane row
// with the TPU kernel's contract: origin pushed 1e-5 along wi, a hit
// counts at 0 < t < dist (1 - 1e-3) - 1e-4 on a triangle other than the
// pixel's own (shadow_limit). The RNG is pcg4d on the global pixel index,
// counters CTR_RIS + j, salt SALT_RESTIR.
//
// Bound: FMA throughput. Per pixel, 2 x l_pad light targets (~32 FLOP
// each), K candidates (~120 FLOP each) and up to n_pad plane tests (~39
// FLOP each): ~22 kFLOP on the headline scene, ~0.7 ms for a 1080p frame
// at 67 TFLOP/s. The light tables (l_pad x 16 floats, twice) stay in
// shared memory for the whole block, as in B7; the plane rows stream
// through shared memory 256 at a time, and a ray stops at its first
// blocking triangle. Lanes whose winner carries no weight skip the ray.
#include "di_core.cuh"

using namespace restir;

namespace {

constexpr int BLOCK = 256;
constexpr int PCHUNK = 256;  // plane rows staged in shared memory per pass

// input / output pack channels (ris_kernel.py:37-41)
enum {
  I_POS = 0, I_NORM = 3, I_WO = 6, I_MTYPE = 9, I_METAL = 10, I_ROUGH = 11,
  I_SHADE = 12, I_PRIM = 13
};
enum { O_LI = 0, O_WI = 3, O_DIST = 6, O_W = 7, O_M = 8, O_PAD = 9 };

__global__ void __launch_bounds__(BLOCK)
    ris_cdf_kernel(const float* __restrict__ in, uint32_t looper,
                   const float* __restrict__ lights_g,
                   const float* __restrict__ psi_g, int l_pad, int n_area,
                   const float* __restrict__ planes, int n_pad,
                   float* __restrict__ out, int r, int single_sided, int k,
                   int has_met) {
  extern __shared__ float4 smem4[];
  float* psi = reinterpret_cast<float*>(smem4);
  float* lights = psi + l_pad * 16;
  float* sp = lights + l_pad * 16;
  for (int i = threadIdx.x; i < l_pad * 16; i += blockDim.x) {
    psi[i] = psi_g[i];
    lights[i] = lights_g[i];
  }
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < r;
  Surface s = {};
  Candidate c = {};
  if (live) {
    const float* g = in + p;
    auto at = [&](int ch) { return g[(size_t)ch * r]; };
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
    c = ris_select<false>(psi, lights, l_pad, n_area, (uint32_t)p, looper, k,
                          single_sided, has_met, s);
  }

  const float limit = shadow_limit(c);
  const float ox = s.px + c.wi[0] * 1e-5f;
  const float oy = s.py + c.wi[1] * 1e-5f;
  const float oz = s.pz + c.wi[2] * 1e-5f;
  const bool trace = live && c.r_weight > 0.0f;
  bool blocked = false;
  for (int base = 0; base < n_pad; base += PCHUNK) {
    const int rows = min(PCHUNK, n_pad - base);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * 12; i += blockDim.x)
      sp[i] = planes[(size_t)base * 12 + i];
    __syncthreads();
    if (!trace || blocked) continue;
    for (int j = 0; j < rows; ++j) {
      float u, v;
      const float t = plane_hit(sp + j * 12, ox, oy, oz, c.wi[0], c.wi[1],
                                c.wi[2], u, v);
      if (t > 0.0f && t < limit && base + j != s.prim) {
        blocked = true;
        break;
      }
    }
  }
  if (!live) return;
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
}

}  // namespace

// in: float32 [14, R]; lights / psi: [l_pad, 16] (tables.light_tables);
// planes: [n_pad, 12]. Writes out [10, R]: li (3), wi (3), dist, weight
// (zero when the winner is occluded), M, 0.
extern "C" int restir_ris_cdf(const float* in, uint32_t looper,
                              const float* lights, const float* psi,
                              int l_pad, int n_area, const float* planes,
                              int n_pad, float* out, int r, int single_sided,
                              int k, int has_met, void* stream) {
  if (k < 1 || k > MAX_K || r <= 0 || l_pad <= 0 || n_pad <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)l_pad * 32 + (size_t)PCHUNK * 12) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ris_cdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ris_cdf_kernel<<<(r + BLOCK - 1) / BLOCK, BLOCK, smem,
                   (cudaStream_t)stream>>>(in, looper, lights, psi, l_pad,
                                           n_area, planes, n_pad, out, r,
                                           single_sided, k, has_met);
  return (int)cudaGetLastError();
}
