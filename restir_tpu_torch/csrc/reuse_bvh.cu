// Kernel B7: RIS candidate selection and the winner's shadow ray through
// an MTBVH any-hit walk, for scenes of any size.
//
// Replaces restir_tpu/ops/pallas/fused_di.py::reuse_pallas up to its
// temporal merge: _ris_select_kernel (K-candidate CDF RIS), and the
// winner visibility of _vis_sorted_kernel (wavefront-sorted rays over
// 32-triangle sub-block work lists; scenes over 1024 triangles) and of
// _vis_resident_kernel (brute loop; resident scenes). Per pixel, one
// thread reads the gb pack column, finds its K light rows, evaluates the
// candidates as B1 does (di_core.cuh, ris_select), and walks the stackless
// MTBVH (bvh.cuh) from the shading point towards the winner with an early
// exit at the first blocking triangle. It writes the rs pack [RS_CH, R];
// B1's temporal kernel (fused_di.cu, di_temporal_kernel) then merges it
// with the previous frame's reuse pack, as _merge_sorted_kernel does.
//
// Bound: the light targets' operations and the shadow walk's dependent
// loads. B1's full two-pass scan evaluates every light row twice (1,280
// targets per pixel under a sky), so B7 searches instead:
// - pass 1 sums the targets of the rows that hold lights (padding rows
//   are 0) in row order and keeps the running cdf after every S-th row
//   in shared memory, one column per thread;
// - each candidate j binary-searches those checkpoints for the first one
//   above thr_j and re-scans that one segment from the checkpoint before
//   it: the same adds in the same order, so idx_j and its target are the
//   full scan's bit for bit (the cdf is non-decreasing: targets are >= 0);
// - env-tile rows (HAS_ENV) take a reduced target that equals the full
//   one bit for bit (env_target): one float4 and one float of
//   shared memory per row in place of a 64-byte psi row.
// So a pixel evaluates at most n_lights + K * S targets. S is the
// smallest of 8, 16, 32 whose checkpoints leave room for the blocks per
// SM that the launch bounds ask for (ris_search.cuh, b7_seg; mirrored on
// the host by ops/kernels/reuse.py, seg_for): 8 on the hall's 128 lights
// (24 KB per block), 16 on its 640 rows under a sky (58 KB, against the
// first design's 80 KB of psi and light rows; the K picked light rows
// are read through the read-only path). Once the search was cheap, the walk took
// most of the time: it waits out chains of dependent node loads, so the
// registers are capped for more warps per SM (launch bounds below), and
// its leaf test reads plane rows as float4 (PlaneRay4). Its warps are 8x4
// pixel tiles of the frame (common.cuh, tile_pixel), though each pixel
// shoots at its own random light, so tiles help it little.
//
// With an env map (template flag HAS_ENV) the 512 env tiles follow the
// area lights as virtual lights, and an env winner's shadow ray runs to
// RESTIR_ENV_DIST.
//
// The streamed build (template flag STREAM) takes the tables that do not
// fit in a block's shared memory staged whole (more than about 2,400 area
// lights): pass 1 reads the area psi rows through a double buffer of
// kChunkRows rows in shared memory (common.cuh, stream_rows), every
// thread of the block at every barrier, threads off the frame included;
// the env tiles' compact rows stay staged; S grows past kSegs (b7_seg)
// until the checkpoints fit beside the buffer at the launch bounds'
// blocks per SM; and each pick re-scans its segment's area rows from
// device memory through the read-only path. The adds are the same in the
// same order, so it picks what the staged build picks, bit for bit. The
// search lives in ris_search.cuh, which B10 shares.
#include "bvh.cuh"
#include "ris_search.cuh"
#if defined(PROBE_WALK)
#include "prof/walk_probe.cuh"  // stage probes (restir_tpu_torch/prof)
#endif

using namespace restir;

namespace {

template <bool COUNT, bool HAS_ENV, bool STREAM>
__global__ void __launch_bounds__(PIX_BLOCK,
                                  HAS_ENV ? kBlocksPerSmEnv : kBlocksPerSm)
    reuse_bvh_kernel(const float* __restrict__ gb, uint32_t looper,
                     const float* __restrict__ lights_g,
                     const float4* __restrict__ psi_g, int l_pad, int n_area,
                     int seg, BvhRows bvh, float* __restrict__ rs,
                     int* __restrict__ stats, int r, int width, int pix0,
                     int single_sided, int k, int has_met) {
  extern __shared__ float4 smem4[];
  const int n_env = HAS_ENV ? kEnvRows : 0;
  float4* area = smem4;  // STREAM: stream_rows' buffer
  float4* env = area + (STREAM ? 2 * PIX_BLOCK : 4 * n_area);
  float* env_lum = reinterpret_cast<float*>(env + n_env);
  if constexpr (!STREAM) {
    for (int i = threadIdx.x; i < 4 * n_area; i += blockDim.x)
      area[i] = psi_g[i];
  }
  for (int i = threadIdx.x; i < n_env; i += blockDim.x) {
    const float4 a = psi_g[4 * (n_area + i)];
    const float4 c = psi_g[4 * (n_area + i) + 3];
    env[i] = make_float4(a.x, a.y, a.z, c.z);
    env_lum[i] = c.y;
  }
  __syncthreads();

  const int g = tile_pixel(width, pix0, r);
  // the streamed build's pass 1 has barriers: a thread off the frame
  // stays for them and returns after it
  if (!STREAM && g < 0) return;
  const bool live = g >= 0;
  const int p = g - pix0;  // the band's pack column
  const LightStage st = {STREAM ? psi_g : area,
                         env,
                         env_lum,
                         env_lum + n_env + threadIdx.x,
                         (int)blockDim.x,
                         n_area,
                         n_area + n_env,
                         seg,
                         area};
  Surface s = {};
  if (live) s = load_surface(gb, p, r);
  int evaluated = 0;
  const Candidate c = ris_select_seg<COUNT, HAS_ENV, STREAM>(
      st, lights_g, l_pad, (uint32_t)g, looper, k, single_sided, has_met, s,
      evaluated, live);
  if (!live) return;
  WalkCount n = {0, 0};
#if defined(PROBE_WALK)
  if (PROBE_WALK == 2) n = {stats[p], stats[(size_t)r + p]};
  const bool occluded = probe_occluded_walk<PROBE_WALK>(
      bvh, PlaneRay4{shadow_ray(s, c)}, shadow_limit(c), s.prim, n);
#else
  const bool occluded = occluded_walk<COUNT>(
      bvh, PlaneRay4{shadow_ray(s, c)}, shadow_limit(c), s.prim, n);
#endif
  write_rs(rs, p, r, c, occluded);
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
    stats[2 * (size_t)r + p] = evaluated;
  }
}

template <bool COUNT, bool HAS_ENV, bool STREAM>
int launch_reuse_bvh(const float* gb, uint32_t looper, const float* lights,
                     const float* psi, int l_pad, int n_area,
                     const BvhRows& bvh, float* rs, int* stats, int r,
                     int width, int pix0, int single_sided, int k,
                     int has_met, cudaStream_t stream) {
  int seg;
  cudaError_t e = b7_seg(n_area, HAS_ENV, STREAM, &seg);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = b7_smem(n_area, HAS_ENV, seg, STREAM);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(reuse_bvh_kernel<COUNT, HAS_ENV, STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  reuse_bvh_kernel<COUNT, HAS_ENV, STREAM>
      <<<tile_grid(width, pix0, r), PIX_BLOCK, smem, stream>>>(
      gb, looper, lights, reinterpret_cast<const float4*>(psi), l_pad,
      n_area, seg, bvh, rs, stats, r, width, pix0, single_sided, k,
      has_met);
  return (int)cudaGetLastError();
}

}  // namespace

// B7's light rows per cdf checkpoint on the current device (the streamed
// build's when `stream`), or minus a CUDA error code.
extern "C" int restir_reuse_bvh_seg(int n_area, int has_env, int stream) {
  int seg;
  const cudaError_t e = b7_seg(n_area, has_env != 0, stream != 0, &seg);
  return e == cudaSuccess ? seg : -(int)e;
}

// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// scene's MTBVH (ops/kernels/tables.py). gb holds the r pixels of a
// frame `width` pixels wide from global pixel pix0 (a row band; the whole
// frame: pix0 = 0), tiled in 2-D over the rows they touch; the RIS draws
// key on the global pixel. stats: null, or int32 [3, r] that receives
// each shadow ray's box and triangle test counts and the light targets
// the pixel evaluated. stream: 0 the staged build (a launch error when
// its shared memory passes the device's limit), 1 the streamed build.
extern "C" int restir_reuse_bvh(const float* gb, uint32_t looper,
                                const float* lights, const float* psi,
                                int l_pad, int n_area, int has_env,
                                int stream, const float* rows, int size,
                                const float* planes, float* rs,
                                int* stats, int r, int width, int pix0,
                                int single_sided, int k, int has_met,
                                void* stream_) {
  if (k < 1 || k > MAX_K || r <= 0 || size <= 0 || width <= 0 ||
      pix0 < 0 || n_area < 0 ||
      n_area + (has_env ? kEnvRows : 0) > l_pad)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(psi) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream_;
#define RESTIR_B7_LAUNCH(C, E, S)                                      \
  launch_reuse_bvh<C, E, S>(gb, looper, lights, psi, l_pad, n_area, bvh, \
                            rs, stats, r, width, pix0, single_sided, k,  \
                            has_met, st)
#define RESTIR_B7_ENV(C, S) \
  (has_env ? RESTIR_B7_LAUNCH(C, true, S) : RESTIR_B7_LAUNCH(C, false, S))
  if (stats)
    return stream ? RESTIR_B7_ENV(true, true) : RESTIR_B7_ENV(true, false);
  return stream ? RESTIR_B7_ENV(false, true) : RESTIR_B7_ENV(false, false);
#undef RESTIR_B7_ENV
#undef RESTIR_B7_LAUNCH
}
