// Kernel B6: G-buffer of a scene of any size, through an MTBVH closest-hit
// walk.
//
// Replaces restir_tpu/ops/pallas/fused_di.py::gbuffer_pack_pallas on
// scenes over 1024 triangles: _gbuffer_kernel_sub (32-triangle sub-block
// work lists) and _gbuffer_kernel (128-triangle cluster work lists), and
// on resident scenes _gbuffer_kernel_resident (the split-chain brute
// loop). The TPU kernels stream frustum-culled triangle blocks through
// VMEM for 8x128-pixel tiles; here one thread per pixel walks the stackless
// MTBVH (bvh.cuh) straight from global memory, through the read-only
// cache, and writes the gb pack [GB_CH, R] in linear pixel order.
//
// Per pixel: raygen with AA jitter, the closest-hit walk (padded-box slab
// tests, unit-plane leaf tests), then B1's G-buffer epilogue
// (di_core.cuh), so the pack equals B1's wherever the hit does. The
// epilogue's env and texture branches are template flags, as in B1.
//
// Bound: neither bytes nor FMAs. The tables (hall: 81,036 planes and
// attribute rows, 6 x 162,071 node rows, ~45 MB) sit in the 50 MB L2 and
// the pack write is 96 B/pixel; the walk is a chain of dependent loads
// (node row -> next node row) whose latency each warp waits out, and a
// warp waits for its longest walk. The design keeps one thread per ray
// with no stack (the walk state is one int), so many warps fit per SM to
// hide that latency, and makes each warp an 8x4 pixel tile (common.cuh,
// tile_pixel): neighbouring rays walk nearly the same nodes, so the
// warp's longest walk is closer to its mean than in a 32x1 strip, and
// each channel store is four whole 32-byte segments. The leaf test reads
// its plane row as three float4 loads (di_core.cuh, PlaneRay4). Its 42-48
// registers let 5 blocks (40 warps) share an SM; a cap for 6 blocks
// spilled and did not pay. Wider nodes and ray sorting are later work.
//
// Stage probes (restir_tpu_torch/prof, prof_gsplit / prof_gvariants): a
// build with -DPROBE_GBUF=1 stores constants only ("const"), =2 adds the
// ray ("raygen"), =3 walks and stores the hit without the epilogue
// ("hit"), =4 runs the epilogue on a constant hit ("epi"). Their packs
// are not the G-buffer. Without the macro this file is the kernel above.
#include "bvh.cuh"
#include "di_core.cuh"

using namespace restir;

namespace {

template <bool COUNT, bool HAS_ENV, bool TEX>
__global__ void __launch_bounds__(PIX_BLOCK) gbuffer_bvh_kernel(
    const float* __restrict__ cam, const float* __restrict__ lcam,
    uint32_t looper, BvhRows bvh, const float* __restrict__ attr,
    const float* __restrict__ mat, int n_mat, EnvTex et,
    float* __restrict__ gb, int* __restrict__ stats, int width, int height,
    int pix0, int r, float aspect, int aa_jitter, int single_sided) {
  const int g = tile_pixel(width, pix0, r);
  if (g < 0) return;
  const int p = g - pix0;  // the band's pack column
#if defined(PROBE_GBUF) && PROBE_GBUF == 1
  // probe "const": the pack's stores alone (no ray, no walk, no epilogue)
  for (int ch = 0; ch < GB_CH; ++ch)
    gb[(size_t)ch * r + p] = __ldg(cam) + (float)ch;
  return;
#endif
  const Ray ray = raygen(cam, g, looper, width, height, aspect, aa_jitter);
#if defined(PROBE_GBUF) && PROBE_GBUF == 2
  // probe "raygen": the ray and the stores
  gb[p] = ray.ox + ray.dx;
  gb[(size_t)r + p] = ray.oy + ray.dy;
  gb[2 * (size_t)r + p] = ray.oz + ray.dz;
  for (int ch = 3; ch < GB_CH; ++ch) gb[(size_t)ch * r + p] = ray.dz;
  return;
#endif
  WalkCount n = {0, 0};
  int prim;
  float bu, bv;
#if defined(PROBE_GBUF) && PROBE_GBUF == 4
  // probe "epi": a constant hit into the real epilogue
  const float best = 5.0f + ray.dx;
  prim = 3;
  bu = bv = 0.3f;
#else
  const PlaneRay4 pr = {{ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz}};
  const float best = closest_walk<COUNT>(bvh, pr, prim, bu, bv, n);
#endif
#if defined(PROBE_GBUF) && PROBE_GBUF == 3
  // probe "hit": the walk, its result stored without the epilogue
  gb[p] = best + bu + bv + (float)prim;
  for (int ch = 1; ch < GB_CH; ++ch) gb[(size_t)ch * r + p] = ray.dx;
#else
  gbuffer_epilogue<HAS_ENV, TEX>(gb, p, r, ray, best, prim, bu, bv, attr,
                                 mat, n_mat, lcam, width, height, aspect,
                                 single_sided, et);
#endif
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT, bool HAS_ENV, bool TEX>
int launch_gbuffer_bvh(const float* cam, const float* lcam, uint32_t looper,
                       const BvhRows& bvh, const float* attr, const float* mat,
                       int n_mat, const EnvTex& et, float* gb, int* stats,
                       int width, int height, int pix0, int r, float aspect,
                       int aa_jitter, int single_sided, cudaStream_t stream) {
  gbuffer_bvh_kernel<COUNT, HAS_ENV, TEX>
      <<<tile_grid(width, pix0, r), PIX_BLOCK, 0, stream>>>(
          cam, lcam, looper, bvh, attr, mat, n_mat, et, gb, stats, width,
          height, pix0, r, aspect, aa_jitter, single_sided);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// scene's MTBVH (ops/kernels/tables.py). The pack holds the r pixels of
// the width x height frame from global pixel pix0 (a row band; the whole
// frame: pix0 = 0, r = width x height): rays, the jitter draw, raster
// coordinates and motion are the frame's, columns the band's. stats:
// null, or int32 [2, r] that receives each ray's box and triangle test
// counts.
extern "C" int restir_gbuffer_bvh(const float* cam, const float* lcam,
                                  uint32_t looper, const float* rows,
                                  int size, const float* planes,
                                  const float* attr, const float* mat,
                                  int n_mat,
                                  const float* env_rad, const float* atlas,
                                  const float* tex_meta, int n_tex,
                                  int has_env, int with_textures, float* gb,
                                  int* stats, int width, int height,
                                  int pix0, int r, float aspect,
                                  int aa_jitter, int single_sided,
                                  void* stream) {
  if (r <= 0 || size <= 0 || width <= 0 || pix0 < 0 ||
      (long long)pix0 + r > (long long)width * height)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const EnvTex et = {reinterpret_cast<const float4*>(env_rad),
                     reinterpret_cast<const float4*>(atlas),
                     reinterpret_cast<const float4*>(tex_meta), n_tex};
  const cudaStream_t st = (cudaStream_t)stream;
#define RESTIR_B6_LAUNCH(C, E, T)                                          \
  launch_gbuffer_bvh<C, E, T>(cam, lcam, looper, bvh, attr, mat, n_mat, et, \
                              gb, stats, width, height, pix0, r, aspect,   \
                              aa_jitter, single_sided, st)
#define RESTIR_B6_FLAGS(C)                                                \
  (has_env ? (with_textures ? RESTIR_B6_LAUNCH(C, true, true)             \
                            : RESTIR_B6_LAUNCH(C, true, false))           \
           : (with_textures ? RESTIR_B6_LAUNCH(C, false, true)            \
                            : RESTIR_B6_LAUNCH(C, false, false)))
  return stats ? RESTIR_B6_FLAGS(true) : RESTIR_B6_FLAGS(false);
#undef RESTIR_B6_FLAGS
#undef RESTIR_B6_LAUNCH
}
