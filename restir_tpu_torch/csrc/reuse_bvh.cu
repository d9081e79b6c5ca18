// Kernel B7: RIS candidate selection and the winner's shadow ray through
// an MTBVH any-hit walk, for scenes of any size.
//
// Replaces restir_tpu/ops/pallas/fused_di.py::reuse_pallas up to its
// temporal merge: _ris_select_kernel (K-candidate CDF RIS), and the
// winner visibility of _vis_sorted_kernel (wavefront-sorted rays over
// 32-triangle sub-block work lists; scenes over 1024 triangles) and of
// _vis_resident_kernel (brute loop; resident scenes). Two launches:
// ris_search.cuh's light search (ris_search_kernel) reads each pixel's gb
// pack column, finds its K light rows, evaluates the candidates as B1
// does (di_core.cuh: ris_select's evaluation, ris_finish) and writes the
// winner to the rs pack [RS_CH, R]; then reuse_walk_kernel walks the
// stackless MTBVH (bvh.cuh) from the shading point towards the winner
// with an early exit at the first blocking triangle and zeroes an
// occluded winner's weight. B1's temporal kernel (fused_di.cu,
// di_temporal_kernel) then merges rs with the previous frame's reuse
// pack, as _merge_sorted_kernel does.
//
// Bound: the light targets' operations and the shadow walk's dependent
// loads. B1's full two-pass scan evaluates every light row twice (1,280
// targets per pixel under a sky), so B7 searches instead:
// - pass 1 sums the targets of the rows that hold lights (padding rows
//   are 0) in row order and keeps the running cdf after every S-th row
//   in shared memory, one column per pixel;
// - each candidate j binary-searches those checkpoints for the first one
//   above thr_j and re-scans that one segment from the checkpoint before
//   it: the same adds in the same order, so idx_j and its target are the
//   full scan's bit for bit (the cdf is non-decreasing: targets are >= 0);
// - env-tile rows (HAS_ENV) take a reduced target that equals the full
//   one bit for bit (env_target): one float4 and one float of
//   shared memory per row in place of a 64-byte psi row.
// So a pixel evaluates at most n_lights + K * S targets. The search
// streams the psi rows through shared memory, several pixels a thread,
// so any light count fits a block; S is the smallest multiple of 8 whose
// checkpoints leave room for the search's blocks per SM (ris_search.cuh,
// b7_seg; mirrored on the host by ops/kernels/reuse.py, seg_for): 8 on
// the hall's 128 lights and 16 on its 640 rows under a sky, 48 on 2,450
// rows, 200 on 10,000. Its launch bounds are its own; the walk's
// registers are capped for more warps per SM (launch bounds below), as
// the walk waits out chains of dependent node loads, and its leaf test
// reads plane rows as float4 (PlaneRay4). Its warps are 8x4 pixel tiles
// of the frame (common.cuh, tile_pixel), though each pixel shoots at its
// own random light, so tiles help it little.
//
// With an env map (template flag HAS_ENV) the 512 env tiles follow the
// area lights as virtual lights, and an env winner's shadow ray runs to
// RESTIR_ENV_DIST.
//
// An earlier design had a second, staged build (the light rows staged
// whole in shared memory, the search and the walk in one kernel of one
// pixel a thread) for the tables that fit a block; this search, forced
// on those tables, ran faster (PERF.md §6), so B7 has one build. B10
// shares the search.
#include "bvh.cuh"
#include "ris_search.cuh"
#if defined(PROBE_WALK)
#include "prof/walk_probe.cuh"  // stage probes (restir_tpu_torch/prof)
#endif

using namespace restir;

namespace {

// The walk's blocks per SM (launch bounds): its registers capped at 64.
constexpr int kWalkBlocksPerSm = 4;

// The search reads a pixel's Surface from the gb pack and writes its
// candidate to the rs pack (the weight before visibility) and, COUNT,
// the light targets it evaluated.
template <bool COUNT>
struct ReuseIo {
  const float* __restrict__ gb;
  float* __restrict__ rs;
  int* __restrict__ stats;
  int r;
  __device__ __forceinline__ Surface surface(int p) const {
    return load_surface(gb, p, r);
  }
  __device__ __forceinline__ void put(int p, const Surface&,
                                      const Candidate& c,
                                      int evaluated) const {
    write_rs(rs, p, r, c, false);
    if (COUNT) stats[2 * (size_t)r + p] = evaluated;
  }
};

// The walk: the shadow ray of the winner that the search wrote to rs,
// from the gb pack's shading point; an occluded winner's weight becomes
// 0.
template <bool COUNT>
__global__ void __launch_bounds__(PIX_BLOCK, kWalkBlocksPerSm)
    reuse_walk_kernel(const float* __restrict__ gb, BvhRows bvh,
                      float* __restrict__ rs, int* __restrict__ stats, int r,
                      int width, int pix0) {
  const int g = tile_pixel(width, pix0, r);
  if (g < 0) return;
  const int p = g - pix0;
  Surface s = {};
  s.px = gb[(size_t)(G_POS + 0) * r + p];
  s.py = gb[(size_t)(G_POS + 1) * r + p];
  s.pz = gb[(size_t)(G_POS + 2) * r + p];
  s.prim = __float2int_rz(gb[(size_t)G_PRIM * r + p]);
  Candidate c = {};
#pragma unroll
  for (int i = 0; i < 3; ++i) c.wi[i] = rs[(size_t)(RS_WI + i) * r + p];
  c.dist = rs[(size_t)RS_DIST * r + p];
  WalkCount n = {0, 0};
#if defined(PROBE_WALK)
  if (PROBE_WALK == 2) n = {stats[p], stats[(size_t)r + p]};
  const bool occluded = probe_occluded_walk<PROBE_WALK>(
      bvh, PlaneRay4{shadow_ray(s, c)}, shadow_limit(c), s.prim, n);
#else
  const bool occluded = occluded_walk<COUNT>(
      bvh, PlaneRay4{shadow_ray(s, c)}, shadow_limit(c), s.prim, n);
#endif
  if (occluded) rs[(size_t)RS_W * r + p] = 0.0f;
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT, bool HAS_ENV>
int launch_reuse_bvh(const float* gb, uint32_t looper, const float* lights,
                     const float* psi, int l_pad, int n_area, int parts,
                     const BvhRows& bvh, float* rs, int* stats, int r,
                     int width, int pix0, int single_sided, int k,
                     int has_met, cudaStream_t st) {
  int seg;
  cudaError_t e = b7_seg(n_area, HAS_ENV, &seg);
  if (e != cudaSuccess) return (int)e;
  if (parts & 1) {
    e = launch_ris_search<COUNT, HAS_ENV>(
        ReuseIo<COUNT>{gb, rs, stats, r}, lights, psi, l_pad, n_area, seg,
        (uint32_t)pix0, looper, r, single_sided, k, has_met, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (parts & 2) {
    reuse_walk_kernel<COUNT><<<tile_grid(width, pix0, r), PIX_BLOCK, 0, st>>>(
        gb, bvh, rs, stats, r, width, pix0);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// B7's light rows per cdf checkpoint on the current device, or minus a
// CUDA error code.
extern "C" int restir_reuse_bvh_seg(int n_area, int has_env) {
  int seg;
  const cudaError_t e = b7_seg(n_area, has_env != 0, &seg);
  return e == cudaSuccess ? seg : -(int)e;
}

// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// scene's MTBVH (ops/kernels/tables.py). gb holds the r pixels of a
// frame `width` pixels wide from global pixel pix0 (a row band; the whole
// frame: pix0 = 0), tiled in 2-D over the rows they touch; the RIS draws
// key on the global pixel. stats: null, or int32 [3, r] that receives
// each shadow ray's box and triangle test counts and the light targets
// the pixel evaluated. parts picks the launches: 1 the search (rs before
// visibility), 2 the walk (on the rs the search wrote), 3 both.
extern "C" int restir_reuse_bvh(const float* gb, uint32_t looper,
                                const float* lights, const float* psi,
                                int l_pad, int n_area, int has_env,
                                int parts, const float* rows, int size,
                                const float* planes, float* rs, int* stats,
                                int r, int width, int pix0, int single_sided,
                                int k, int has_met, void* stream_) {
  if (k < 1 || k > MAX_K || r <= 0 || size <= 0 || width <= 0 ||
      pix0 < 0 || n_area < 0 ||
      n_area + (has_env ? kEnvRows : 0) > l_pad || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(psi) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream_;
#define RESTIR_B7_LAUNCH(C, E)                                              \
  launch_reuse_bvh<C, E>(gb, looper, lights, psi, l_pad, n_area, parts, bvh, \
                         rs, stats, r, width, pix0, single_sided, k,        \
                         has_met, st)
  if (stats)
    return has_env ? RESTIR_B7_LAUNCH(true, true)
                   : RESTIR_B7_LAUNCH(true, false);
  return has_env ? RESTIR_B7_LAUNCH(false, true)
                 : RESTIR_B7_LAUNCH(false, false);
#undef RESTIR_B7_LAUNCH
}
