// Kernel B7: RIS candidate selection and the winner's shadow ray through
// an MTBVH any-hit walk, for scenes of any size.
//
// Replaces restir_tpu/ops/pallas/fused_di.py::reuse_pallas up to its
// temporal merge: _ris_select_kernel (K-candidate CDF RIS), and the
// winner visibility of _vis_sorted_kernel (wavefront-sorted rays over
// 32-triangle sub-block work lists; scenes over 1024 triangles) and of
// _vis_resident_kernel (brute loop; resident scenes). Per pixel, one
// thread reads the gb pack column, runs B1's RIS core (di_core.cuh) over
// the light tables held in shared memory, and walks the stackless MTBVH
// (bvh.cuh) from the shading point towards the winner with an early exit
// at the first blocking triangle. It writes the rs pack [RS_CH, R]; B1's
// temporal kernel (fused_di.cu, di_temporal_kernel) then merges it with
// the previous frame's reuse pack, as _merge_sorted_kernel does.
//
// Bound: FMA throughput for the RIS core (2 x l_pad light targets per
// pixel, ~8 kFLOP at l_pad = 128), then the latency of the shadow walk's
// dependent loads. Lanes without a live winner skip the walk.
//
// With an env map (template flag HAS_ENV) the 512 env tiles join the light
// tables as virtual lights (l_pad 128 -> 640 on the hall: 80 KB of shared
// memory per block, through the dynamic shared-memory opt-in), and an env
// winner's shadow ray runs to RESTIR_ENV_DIST.
#include "bvh.cuh"
#include "di_core.cuh"

using namespace restir;

namespace {

template <bool COUNT, bool HAS_ENV>
__global__ void __launch_bounds__(256) reuse_bvh_kernel(
    const float* __restrict__ gb, uint32_t looper,
    const float* __restrict__ lights_g, const float* __restrict__ psi_g,
    int l_pad, int n_area, BvhRows bvh, float* __restrict__ rs,
    int* __restrict__ stats, int r, int single_sided, int k, int has_met) {
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
  const Surface s = load_surface(gb, p, r);
  const Candidate c = ris_select<HAS_ENV>(psi, lights, l_pad, n_area,
                                          (uint32_t)p, looper, k,
                                          single_sided, has_met, s);
  WalkCount n = {0, 0};
  const bool occluded = occluded_walk<COUNT>(bvh, shadow_ray(s, c),
                                             shadow_limit(c), s.prim, n);
  write_rs(rs, p, r, c, occluded);
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT, bool HAS_ENV>
int launch_reuse_bvh(const float* gb, uint32_t looper, const float* lights,
                     const float* psi, int l_pad, int n_area,
                     const BvhRows& bvh, float* rs, int* stats, int r,
                     int single_sided, int k, int has_met,
                     cudaStream_t stream) {
  const size_t smem = (size_t)l_pad * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reuse_bvh_kernel<COUNT, HAS_ENV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int block = 256;
  reuse_bvh_kernel<COUNT, HAS_ENV>
      <<<(r + block - 1) / block, block, smem, stream>>>(
          gb, looper, lights, psi, l_pad, n_area, bvh, rs, stats, r,
          single_sided, k, has_met);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// scene's MTBVH (ops/kernels/tables.py). stats: null, or int32 [2, R]
// that receives each shadow ray's box and triangle test counts.
extern "C" int restir_reuse_bvh(const float* gb, uint32_t looper,
                                const float* lights, const float* psi,
                                int l_pad, int n_area, int has_env,
                                const float* rows, int size,
                                const float* planes, float* rs,
                                int* stats, int r, int single_sided, int k,
                                int has_met, void* stream) {
  if (k < 1 || k > MAX_K || r <= 0 || size <= 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream;
#define RESTIR_B7_LAUNCH(C, E)                                              \
  launch_reuse_bvh<C, E>(gb, looper, lights, psi, l_pad, n_area, bvh, rs,   \
                         stats, r, single_sided, k, has_met, st)
  if (stats)
    return has_env ? RESTIR_B7_LAUNCH(true, true)
                   : RESTIR_B7_LAUNCH(true, false);
  return has_env ? RESTIR_B7_LAUNCH(false, true)
                 : RESTIR_B7_LAUNCH(false, false);
#undef RESTIR_B7_LAUNCH
}
