// Kernel B1: fused resident ReSTIR DI (hit + G-buffer + RIS + visibility
// + temporal merge).
//
// Replaces restir_tpu/ops/pallas/fused_di.py::_di_resident_kernel
// (di_resident_pallas). One thread per pixel, in two launches:
//   (a) di_gbuffer_ris_kernel: raygen with AA jitter, the MTBVH
//       closest-hit walk (bvh.cuh) over the resident scene's tables, the
//       G-buffer epilogue with motion reprojection (writes gb), K-candidate
//       CDF RIS with a single-draw winner and the winner's MTBVH any-hit
//       walk (writes rs);
//   (b) di_temporal_kernel (B1b): one 1024-thread block per 1024-pixel
//       tile reduces the tile's minimum valid motion index to the
//       temporal window start (fused_di._window_start; 2048 pixels on a
//       whole frame) and merges each pixel with the previous frame's
//       reuse pack (writes pt). On a row band (the multi-device step,
//       restir_tpu_torch.parallel) the previous pack is the band with
//       +-window halos from its neighbours: motion is rebased to its
//       first pixel and the temporal draw keys on the global pixel.
// Launch (a) is B6 (gbuffer_bvh.cu) and B7's RIS + any hit (reuse_bvh.cu)
// in one kernel: the same walks with the same leaf test, so nothing goes
// back to device memory between the stages and the packs equal B6 +
// B7's. The light and psi rows live in shared memory (every thread of a
// warp reads the same row, a broadcast); the walks read the node rows
// with their boxes copied in (`BvhRows`, one dependent load per step)
// and the leaf planes through the read-only cache (the headline scene's
// ~185 KB stay in L1 / L2), and the winner's attribute and material rows
// come from global memory.
//
// Bound: FMA work in the RIS core, 2 x l_pad light targets per pixel
// (two passes over the light CDF, so no per-pixel CDF array is stored),
// then the walks' chains of dependent loads: the TPU kernel's brute loop
// tested every triangle row twice per pixel, the walks test ~160 boxes
// and ~4 rows on the headline scene. Memory traffic is ~(24 + 8) +
// (8 + 16 + 16) floats per pixel, well under either. The launch bounds
// cap the env-less builds at 80 registers (3 blocks of 256 per SM; ptxas
// spills 120-220 bytes to L1), 12 % faster than 110 registers on the
// headline scene; the env build's 80 KB of light rows allow 2 blocks
// whatever its registers, so it keeps them (capped, it was 4 % slower).
//
// The per-pixel stages (raygen, plane test, epilogue, RIS core, shadow
// ray limit) live in di_core.cuh, shared with B6 and B7; on scenes over
// 1024 triangles B6 + B7 replace launch (a) and launch (b) runs unchanged
// after them. Launch (a) is built four times, for the env map (HAS_ENV:
// 512 env-tile rows join the light tables, l_pad 128 -> 640 on the
// headline scene, and misses read the env radiance) and for textures
// (TEX: atlas fetches in the epilogue, from global memory through the
// read-only cache); the env-less, texture-less instance is the build
// without those branches.
//
// The RNG counters are the JAX package's: candidate j draws
// pcg4d(p, looper, 8 + j, SALT_RESTIR), the jitter pcg4d(p, looper, 0,
// SALT_CAMERA), the temporal draw pcg4d(p, looper, 0, SALT_RESTIR); the
// winner-selection draw is candidate 0's fourth uniform.
#include "bvh.cuh"
#include "di_core.cuh"

using namespace restir;

namespace {

template <bool HAS_ENV, bool TEX>
__global__ void __launch_bounds__(256, HAS_ENV ? 1 : 3) di_gbuffer_ris_kernel(
    const float* __restrict__ cam, const float* __restrict__ lcam,
    uint32_t looper, BvhRows bvh, const float* __restrict__ attr,
    const float* __restrict__ mat, int n_mat,
    const float* __restrict__ lights_g, const float* __restrict__ psi_g,
    int l_pad, int n_area, EnvTex et, float* __restrict__ gb,
    float* __restrict__ rs, int width, int height, float aspect,
    int aa_jitter, int single_sided, int k, int has_met) {
  extern __shared__ float4 smem4[];
  float* psi = reinterpret_cast<float*>(smem4);
  float* lights = psi + l_pad * 16;
  for (int i = threadIdx.x; i < l_pad * 16; i += blockDim.x) {
    psi[i] = psi_g[i];
    lights[i] = lights_g[i];
  }
  __syncthreads();

  const int r = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  const Ray ray = raygen(cam, p, looper, width, height, aspect, aa_jitter);

  // ---- closest hit; equal distances keep the lowest index
  WalkCount n = {0, 0};
  int bprim;
  float bu, bv;
  const PlaneRay pr = {ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz};
  const float best = closest_walk<false>(bvh, pr, bprim, bu, bv, n);

  const Surface s = gbuffer_epilogue<HAS_ENV, TEX>(
      gb, p, r, ray, best, bprim, bu, bv, attr, mat, n_mat, lcam, width,
      height, aspect, single_sided, et);
  const Candidate c = ris_select<HAS_ENV>(psi, lights, l_pad, n_area,
                                          (uint32_t)p, looper, k,
                                          single_sided, has_met, s);

  // ---- winner visibility: any hit before the light, own triangle excluded
  const bool occluded = occluded_walk<false>(bvh, shadow_ray(s, c),
                                             shadow_limit(c), s.prim, n);
  write_rs(rs, p, r, c, occluded);
}

__global__ void __launch_bounds__(TILE) di_temporal_kernel(
    const float* __restrict__ gb, const float* __restrict__ rs,
    const float* __restrict__ prev, float* __restrict__ pt, int r,
    int r_prev, int pix0, int prev_base, int window, uint32_t looper, int k,
    int temporal, float cap) {
  const int p = blockIdx.x * TILE + threadIdx.x;
  const float* g = gb + p;
  const float motion = rebase_motion(g[(size_t)G_MOTION * r], prev_base);
  const bool miss = g[(size_t)G_MISS * r] > 0.5f;
  const bool shade = g[(size_t)G_SHADE * r] > 0.5f;
  const float prim_remap = g[(size_t)G_PRIMR * r];
  const float gnx = g[(size_t)(G_NORM + 0) * r];
  const float gny = g[(size_t)(G_NORM + 1) * r];
  const float gnz = g[(size_t)(G_NORM + 2) * r];
  const float depth = g[(size_t)G_DEPTH * r];

  const float* s = rs + p;
  float li[3] = {s[(size_t)(RS_LI + 0) * r], s[(size_t)(RS_LI + 1) * r],
                 s[(size_t)(RS_LI + 2) * r]};
  float wi[3] = {s[(size_t)(RS_WI + 0) * r], s[(size_t)(RS_WI + 1) * r],
                 s[(size_t)(RS_WI + 2) * r]};
  float dist = s[(size_t)RS_DIST * r];
  float r_weight = s[(size_t)RS_W * r];
  float r_m = shade ? (float)k : 0.0f;

  if (temporal) {
    const int w0 = tile_window_start(motion, miss, r_prev, window);

    const int mot = __float2int_rz(motion);
    const int rel = mot - w0;
    const bool in_win = mot >= 0 && rel >= 0 && rel < window && mot < r_prev;
    if (in_win) {
      const float* nb = prev + mot;
      float n_weight = nb[(size_t)P_WEIGHT * r_prev];
      float n_m = nb[(size_t)P_M * r_prev];
      bool ok =
          prim_remap > -1.0f && nb[(size_t)P_PRIMR * r_prev] == prim_remap;
      ok = ok && fabsf(gnx * nb[(size_t)(P_NORM + 0) * r_prev] +
                       gny * nb[(size_t)(P_NORM + 1) * r_prev] +
                       gnz * nb[(size_t)(P_NORM + 2) * r_prev]) >= 0.9f;
      ok = ok && fabsf(nb[(size_t)P_DEPTH * r_prev] - depth) <= depth * 0.1f;
      ok = ok && shade && !bad_weight(n_weight);
      if (ok) {
        // preClampedMerge: clamp the history to (cap - 1) * M
        const float limit_m = r_m > 0.0f ? (cap - 1.0f) * r_m : n_m;
        if (n_m > limit_m) {
          n_weight = n_weight * (limit_m / fmaxf(n_m, 1.0f));
          n_m = limit_m;
        }
        uint32_t h[4];
        pcg4d((uint32_t)(pix0 + p), looper, (uint32_t)CTR_TEMPORAL,
              SALT_RESTIR, h);
        const float r_t = unit(h[0]);
        const float w_new = r_weight + n_weight;
        if (r_t * w_new < n_weight) {
          li[0] = nb[(size_t)(P_LI + 0) * r_prev];
          li[1] = nb[(size_t)(P_LI + 1) * r_prev];
          li[2] = nb[(size_t)(P_LI + 2) * r_prev];
          wi[0] = nb[(size_t)(P_WI + 0) * r_prev];
          wi[1] = nb[(size_t)(P_WI + 1) * r_prev];
          wi[2] = nb[(size_t)(P_WI + 2) * r_prev];
          dist = nb[(size_t)P_DIST * r_prev];
        }
        r_weight = w_new;
        r_m = r_m + n_m;
      }
    }
  }
  if (bad_weight(r_weight)) {
    r_weight = 0.0f;
    r_m = 0.0f;
  }

  float* o = pt + p;
  o[(size_t)(P_LI + 0) * r] = li[0];
  o[(size_t)(P_LI + 1) * r] = li[1];
  o[(size_t)(P_LI + 2) * r] = li[2];
  o[(size_t)(P_WI + 0) * r] = wi[0];
  o[(size_t)(P_WI + 1) * r] = wi[1];
  o[(size_t)(P_WI + 2) * r] = wi[2];
  o[(size_t)P_DIST * r] = dist;
  o[(size_t)P_WEIGHT * r] = r_weight;
  o[(size_t)P_M * r] = r_m;
  o[(size_t)P_PRIMR * r] = prim_remap;
  o[(size_t)(P_NORM + 0) * r] = gnx;
  o[(size_t)(P_NORM + 1) * r] = gny;
  o[(size_t)(P_NORM + 2) * r] = gnz;
  o[(size_t)P_DEPTH * r] = depth;
  o[(size_t)14 * r] = 0.0f;
  o[(size_t)15 * r] = 0.0f;
}

}  // namespace

extern "C" const char* restir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

template <bool HAS_ENV, bool TEX>
int launch_gbuffer_ris(const float* cam, const float* lcam, uint32_t looper,
                       const BvhRows& bvh, const float* attr,
                       const float* mat, int n_mat, const float* lights,
                       const float* psi, int l_pad, int n_area,
                       const EnvTex& et, float* gb, float* rs, int width,
                       int height, float aspect, int aa_jitter,
                       int single_sided, int k, int has_met,
                       cudaStream_t stream) {
  const int r = width * height;
  const size_t smem = (size_t)l_pad * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        di_gbuffer_ris_kernel<HAS_ENV, TEX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int block = 256;
  di_gbuffer_ris_kernel<HAS_ENV, TEX>
      <<<(r + block - 1) / block, block, smem, stream>>>(
          cam, lcam, looper, bvh, attr, mat, n_mat, lights, psi, l_pad,
          n_area, et, gb, rs, width, height, aspect, aa_jitter,
          single_sided, k, has_met);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [6B, 8] (node rows with their boxes), planes [n_pad, 12]: the
// resident scene's MTBVH (ops/kernels/tables.py).
extern "C" int restir_di_resident_gbuffer_ris(
    const float* cam, const float* lcam, uint32_t looper, const float* rows,
    int size, const float* planes, const float* attr,
    const float* mat, int n_mat, const float* lights, const float* psi,
    int l_pad, int n_area, const float* env_rad, const float* atlas,
    const float* tex_meta, int n_tex, int has_env, int with_textures,
    float* gb, float* rs, int width, int height, float aspect,
    int aa_jitter, int single_sided, int k, int has_met, void* stream) {
  if (k < 1 || k > MAX_K || size <= 0) return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const EnvTex et = {reinterpret_cast<const float4*>(env_rad),
                     reinterpret_cast<const float4*>(atlas),
                     reinterpret_cast<const float4*>(tex_meta), n_tex};
  const cudaStream_t st = (cudaStream_t)stream;
#define RESTIR_B1_LAUNCH(E, T)                                              \
  launch_gbuffer_ris<E, T>(cam, lcam, looper, bvh, attr, mat, n_mat,        \
                           lights, psi, l_pad, n_area, et, gb, rs, width,   \
                           height, aspect, aa_jitter, single_sided, k,      \
                           has_met, st)
  if (has_env)
    return with_textures ? RESTIR_B1_LAUNCH(true, true)
                         : RESTIR_B1_LAUNCH(true, false);
  return with_textures ? RESTIR_B1_LAUNCH(false, true)
                       : RESTIR_B1_LAUNCH(false, false);
#undef RESTIR_B1_LAUNCH
}

// prev: the previous frame's pt pack of r_prev pixels from global pixel
// prev_base (a whole frame: r_prev = r, prev_base = 0; a row band's pack
// with its +-window halos), window: the temporal window, a multiple of
// TILE. pix0: the band's first global pixel (the temporal draw's key).
extern "C" int restir_di_resident_temporal(const float* gb, const float* rs,
                                           const float* prev, float* pt, int r,
                                           int r_prev, int pix0,
                                           int prev_base, int window,
                                           uint32_t looper, int k,
                                           int temporal, float cap,
                                           void* stream) {
  if (r <= 0 || r % TILE != 0 || r_prev <= 0 || window <= 0 ||
      window % TILE != 0 || pix0 < 0)
    return (int)cudaErrorInvalidValue;
  di_temporal_kernel<<<r / TILE, TILE, 0, (cudaStream_t)stream>>>(
      gb, rs, prev, pt, r, r_prev, pix0, prev_base, window, looper, k,
      temporal, cap);
  return (int)cudaGetLastError();
}
