// Kernel B9: the ReSTIR GI resolve of one frame.
//
// Replaces restir_tpu/ops/pallas/gi_kernel.py: _gi_resolve_kernel
// (gi_resolve_pallas). Per pixel, from B8's [GO_CH, R] pack: the sample
// (Lo zeroed when not finite, validity), its RIS weight lum(Lo) / pdf and
// the update of an empty reservoir (take iff r w < w); the temporal merge
// with the previous frame's [Q_CH, R] pack at the motion index (same
// primitive, |n.n'| >= 0.9, |depth - depth'| <= 0.1 depth, a finite
// non-negative weight; take iff r w_new < w'); the M cap; the shade
// Lo / lum(Lo) W / M f cos at the visible point on the demodulated
// material, modulated by the albedo; then check_validity. Writes the
// indirect radiance [3, R] and the next pack [Q_CH, R] (channels 22-23
// zero). Draws: pcg4d(pix0 + p, looper, 0 | 1, SALT_GI).
//
// Row bands (restir_tpu_torch.parallel). A band of whole tiles passes
// pix0, its first global pixel, the key of its draws; q_prev holds the
// previous pack's global pixels [prev_base, prev_base + n_prev), the
// range the band's motion indices reach, and r_prev is the previous
// frame's global pixel count, which clips each tile's window start, so a
// tile picks the single-device window. A read outside the held range
// counts as outside the window; no lane whose merge can pass reads there.
// The whole frame is pix0 = prev_base = 0, n_prev = r_prev.
//
// Design. One thread per pixel, one 1024-thread block per 1024-pixel
// tile. The temporal window is the TPU kernel's: the tile's least motion
// index among pixels with motion >= 0 and a primitive, floored to 128
// and clipped to [0, R_prev - 2048]; a motion outside [w0, w0 + 2048)
// gets no temporal reuse, so the result equals the TPU kernel's. The
// one-hot bf16 window gather of the TPU becomes a direct load of the
// previous pack at the motion index. Other tiles read the previous pack
// anywhere, so the next pack is a new tensor, never written in place.
//
// Bound: bytes. It reads 56 float32 channels per pixel (GO 14, IN 10,
// GQ 10, previous Q 22) and writes 27 (Q 24, indirect 3): ~332 B per
// pixel, ~0.21 ms at 1080p and 3.35 TB/s.
//
// Numerics: built with -fmad=false; every expression follows the plain
// twin (ops/kernels/gi.py gi_resolve_ref) operation for operation.
#include "gi_core.cuh"

using namespace restir;
using namespace restir::gi;

namespace {

constexpr int GI_WINDOW = 2048;

__device__ __forceinline__ bool bad(float x) { return isnan(x) || isinf(x); }

// The tile's window start; every thread of the TILE-thread block calls it.
// Keys on prim > -1 where common.cuh's tile_window_start keys on the
// miss flag.
__device__ __forceinline__ int gi_window_start(float motion, float prim,
                                               int r_prev) {
  __shared__ float warp_min[TILE / 32];
  __shared__ int w0_s;
  float mv = (motion >= 0.0f && prim > -1.0f) ? motion : (float)r_prev;
  for (int off = 16; off > 0; off >>= 1)
    mv = fminf(mv, __shfl_down_sync(0xffffffffu, mv, off));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = mv;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = warp_min[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1)
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (threadIdx.x == 0) {
      int w0 = (__float2int_rz(v) / 128) * 128;
      w0 = min(max(w0, 0), max(r_prev - GI_WINDOW, 0));
      w0_s = w0;
    }
  }
  __syncthreads();
  return w0_s;
}

__global__ void __launch_bounds__(TILE)
    gi_resolve_kernel(const float* __restrict__ go,
                      const float* __restrict__ in,
                      const float* __restrict__ gq,
                      const float* __restrict__ q_prev, int r_prev,
                      int n_prev, int prev_base, int r, uint32_t looper,
                      uint32_t pix0, int temporal, int temporal_clamp,
                      int has_met, float* __restrict__ ind,
                      float* __restrict__ q) {
  const int p = blockIdx.x * TILE + threadIdx.x;  // r % TILE == 0
  const uint32_t key = pix0 + (uint32_t)p;  // the global pixel
  auto G = [&](int c) { return go[(size_t)c * r + p]; };
  auto I = [&](int c) { return in[(size_t)c * r + p]; };
  auto Q = [&](int c) { return gq[(size_t)c * r + p]; };
  const float motion_f = Q(GQ_MOTION), prim = Q(GQ_PRIM);
  const int w0 = temporal ? gi_window_start(motion_f, prim, r_prev) : 0;

  // the candidate sample (trace_gi_sample_fused's epilogue)
  float lx = G(GO_LO), ly = G(GO_LO + 1), lz = G(GO_LO + 2);
  if (bad(lx) || bad(ly) || bad(lz)) lx = ly = lz = 0.0f;
  const V3 xv = v3(I(IN_POS), I(IN_POS + 1), I(IN_POS + 2));
  const V3 xs = v3(G(GO_XS), G(GO_XS + 1), G(GO_XS + 2));
  const float prim_pdf = G(GO_PDF);
  const bool prim_delta = G(GO_DELTA) > 0.5f;
  const float lum = 0.2126f * lx + 0.7152f * ly + 0.0722f * lz;
  const V3 dx = sub(xs, xv);
  const float seg2 = dx.x * dx.x + dx.y * dx.y + dx.z * dx.z;
  const bool valid = lum >= 1e-8f && seg2 > 0.0f;

  // RIS weight and the update of an empty reservoir (restir.cu:375-385)
  float w = lum / clampmin(prim_pdf, 1e-20f);
  if (bad(w) || w < 0.0f || !valid) w = 0.0f;
  uint32_t h[4];
  pcg4d(key, looper, GI_CTR_UPDATE, SALT_GI, h);
  const bool take0 = unit(h[0]) * w < w;
  float s[15];
  {
    const float cand[15] = {lx,       ly,       lz,       xv.x,     xv.y,
                            xv.z,     G(GO_NV), G(GO_NV + 1), G(GO_NV + 2),
                            xs.x,     xs.y,     xs.z,     G(GO_NS),
                            G(GO_NS + 1), G(GO_NS + 2)};
#pragma unroll
    for (int i = 0; i < 15; ++i) s[i] = take0 ? cand[i] : 0.0f;
  }
  float r_w = w, r_m = 1.0f;
  const V3 gn = v3(Q(GQ_NORM), Q(GQ_NORM + 1), Q(GQ_NORM + 2));
  const float depth = Q(GQ_DEPTH);

  if (temporal) {
    // findTemporalNeighbor (restir.cu:21-45) inside the tile's window
    const int motion = __float2int_rz(motion_f);
    const int rel = motion - w0;
    const bool in_win = motion >= 0 && rel >= 0 && rel < GI_WINDOW;
    const int at = (in_win ? motion : w0) - prev_base;
    const bool held = at >= 0 && at < n_prev;
    const float* qp = q_prev + (held ? at : 0);
    auto P = [&](int c) { return qp[(size_t)c * n_prev]; };
    const float n_w = P(Q_W), n_m = P(Q_M);
    bool ok = in_win && held && prim > -1.0f && P(Q_PRIM) == prim;
    ok = ok && fabsf(gn.x * P(Q_GNORM) + gn.y * P(Q_GNORM + 1) +
                     gn.z * P(Q_GNORM + 2)) >= 0.9f;
    ok = ok && fabsf(P(Q_DEPTH) - depth) <= depth * 0.1f;
    ok = ok && !(bad(n_w) || n_w < 0.0f);
    pcg4d(key, looper, GI_CTR_TEMPORAL, SALT_GI, h);
    const float w_new = ok ? r_w + n_w : r_w;
    const float m_new = ok ? r_m + n_m : r_m;
    if (ok && unit(h[0]) * w_new < n_w) {
#pragma unroll
      for (int i = 0; i < 15; ++i) s[i] = P(Q_LO + i);
    }
    r_w = w_new;
    r_m = m_new;
  }

  // M cap (restir.h:88-93)
  const float cap = (float)temporal_clamp;
  if (r_m > cap) {
    r_w = r_w * (cap / clampmin(r_m, 1.0f));
    r_m = cap;
  }

  // shade at the visible point, demodulated (restir.cu:399-408)
  V3 wi = v3(s[9] - s[3], s[10] - s[4], s[11] - s[5]);
  const float inv_l =
      1.0f / clampmin(sqrtf(wi.x * wi.x + wi.y * wi.y + wi.z * wi.z), 1e-20f);
  wi = scale(wi, inv_l);
  const V3 wo = v3(-I(IN_DIR), -I(IN_DIR + 1), -I(IN_DIR + 2));
  const V3 snv = v3(s[6], s[7], s[8]);
  const float scalar = 0.2126f * s[0] + 0.7152f * s[1] + 0.0722f * s[2];
  const float w_big = r_w / clampmin(r_m, 1.0f);
  const float inv_sc = 1.0f / clampmin(scalar, 1e-20f);
  const float f = bsdf_lum(I(IN_MTYPE), I(IN_METAL), I(IN_ROUGH), snv.x,
                           snv.y, snv.z, wo.x, wo.y, wo.z, wi.x, wi.y, wi.z,
                           has_met);
  const float cosw =
      prim_delta ? 1.0f
                 : clampmin(snv.x * wi.x + snv.y * wi.y + snv.z * wi.z, 0.0f);
  const float fc = f * cosw;
  float ix = s[0] * inv_sc * w_big * fc;
  float iy = s[1] * inv_sc * w_big * fc;
  float iz = s[2] * inv_sc * w_big * fc;
  const bool res_bad = bad(r_w) || r_w < 0.0f;
  if (!(Q(GQ_SHADE) > 0.5f && !res_bad && scalar > 0.0f)) ix = iy = iz = 0.0f;
  if (bad(ix) || bad(iy) || bad(iz)) ix = iy = iz = 0.0f;
  ind[p] = ix * Q(GQ_ALB);
  ind[(size_t)r + p] = iy * Q(GQ_ALB + 1);
  ind[2 * (size_t)r + p] = iz * Q(GQ_ALB + 2);

  // check_validity (restir.h:55-59)
  if (res_bad) r_w = r_m = 0.0f;
  float* qo = q + p;
  auto put = [&](int c, float v) { qo[(size_t)c * r] = v; };
#pragma unroll
  for (int i = 0; i < 15; ++i) put(Q_LO + i, s[i]);
  put(Q_W, r_w);
  put(Q_M, r_m);
  put(Q_PRIM, prim);
  put(Q_GNORM, gn.x);
  put(Q_GNORM + 1, gn.y);
  put(Q_GNORM + 2, gn.z);
  put(Q_DEPTH, depth);
  put(Q_DEPTH + 1, 0.0f);
  put(Q_DEPTH + 2, 0.0f);
}

}  // namespace

// go [GO_CH, R], in [IN_CH, R], gq [GQ_CH, R], R a multiple of 1024;
// q_prev [Q_CH, n_prev]: the previous pack's global pixels from prev_base
// of a frame of r_prev pixels; pix0: the global index of pixel 0. Writes
// ind [3, R] and q [Q_CH, R].
extern "C" int restir_gi_resolve(const float* go, const float* in,
                                 const float* gq, const float* q_prev,
                                 int r_prev, int n_prev, int prev_base,
                                 int r, uint32_t looper, uint32_t pix0,
                                 int temporal, int temporal_clamp,
                                 int has_met, float* ind, float* q,
                                 void* stream) {
  if (r <= 0 || r % TILE != 0 || r_prev <= 0 || n_prev <= 0 ||
      prev_base < 0)
    return (int)cudaErrorInvalidValue;
  gi_resolve_kernel<<<r / TILE, TILE, 0, (cudaStream_t)stream>>>(
      go, in, gq, q_prev, r_prev, n_prev, prev_base, r, looper, pix0,
      temporal, temporal_clamp, has_met, ind, q);
  return (int)cudaGetLastError();
}
