// Kernel B2: spatial reuse + shading + running-mean accumulation.
//
// Replaces restir_tpu/ops/pallas/fused_di.py::_spatial_kernel
// (spatial_shade_pallas). One thread per pixel. The per-(1024-pixel tile,
// neighbour, frame) offsets come in as a table ([T, N, 5] int32: aligned
// start, dx, dy, lane residue, valid) built by the Python glue, exactly as
// the JAX wrapper builds it; this kernel reads dx, dy and valid and loads
// each neighbour's reuse row directly (no window DMA) where the TPU
// kernel's window lands it: at start + residue + the pixel's lane in its
// tile, which is p + dy * W + dx unless the start was clamped. On a row
// band (restir_tpu_torch.parallel) neighbours come from the band's pt
// pack with +-halo rows from its neighbours (pt_ext, r_ext pixels), the
// offsets' validity is judged on the whole frame's pixels, and the draws
// key on the global pixel pix0 + p; a whole frame passes pt_ext = pt.
// A neighbour is rejected out of frame, on a primitive mismatch, when
// n . n' < 0.9 (no abs, unlike the temporal test), on depth beyond 10% or
// on a bad weight. The winner is one draw over the cumulative neighbour
// weights (ctr 1), the self-merge draw uses ctr 1 + N.
//
// accum is updated IN PLACE: each thread reads and then writes only its
// own pixel's three accumulator values.
//
// Bound: device memory. Per pixel it reads the 24-channel G-buffer row
// (14 channels used), its own 16-channel reuse row and up to N = 5
// neighbour rows (~6 channels each unless accepted), and reads + writes
// 3 accumulator floats: ~40-60 floats, coalesced per channel.
#include "common.cuh"

using namespace restir;

namespace {

constexpr int MAX_N = 16;

__global__ void __launch_bounds__(256) spatial_shade_kernel(
    const int* __restrict__ offs, const float* __restrict__ gb,
    const float* __restrict__ pt, const float* __restrict__ pt_ext,
    float* accum, int r, int r_ext, int width, int height, int pix0,
    uint32_t looper, int iteration, int neighbors, int flags) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  const bool reuse_spatial = flags & 1;
  const bool accumulate = flags & 2;
  const int has_met = (flags >> 2) & 1;

  const float* g = gb + p;
  auto G = [&](int c) { return g[(size_t)c * r]; };
  const float gnx = G(G_NORM), gny = G(G_NORM + 1), gnz = G(G_NORM + 2);
  const bool shade = G(G_SHADE) > 0.5f;

  const float* s = pt + p;
  float li[3] = {s[(size_t)(P_LI + 0) * r], s[(size_t)(P_LI + 1) * r],
                 s[(size_t)(P_LI + 2) * r]};
  float wi[3] = {s[(size_t)(P_WI + 0) * r], s[(size_t)(P_WI + 1) * r],
                 s[(size_t)(P_WI + 2) * r]};
  float r_weight = s[(size_t)P_WEIGHT * r];
  float r_m = s[(size_t)P_M * r];

  if (reuse_spatial) {
    const float x = G(G_X), y = G(G_Y);
    const float depth = G(G_DEPTH), prim_remap = G(G_PRIMR);
    const int* o = offs + (size_t)(p / TILE) * neighbors * 5;
    float cums[MAX_N];
    int nq[MAX_N];  // accepted neighbour's pixel in pt_ext, or -1
    float a_weight = 0.0f, a_m = 0.0f;
#pragma unroll
    for (int i = 0; i < MAX_N; ++i) {
      nq[i] = -1;
      cums[i] = 0.0f;
      if (i >= neighbors) continue;
      const int dx = o[i * 5 + 1], dy = o[i * 5 + 2];
      const float npx = x + (float)dx, npy = y + (float)dy;
      bool ok = o[i * 5 + 4] > 0 && npx >= 0.0f && npx < (float)width &&
                npy >= 0.0f && npy < (float)height;
      float wgt = 0.0f, m = 0.0f;
      if (ok) {
        const int q = o[i * 5] + o[i * 5 + 3] + p % TILE;
        const float* nb = pt_ext + q;
        wgt = nb[(size_t)P_WEIGHT * r_ext];
        ok = nb[(size_t)P_PRIMR * r_ext] == prim_remap;
        ok = ok && (gnx * nb[(size_t)(P_NORM + 0) * r_ext] +
                    gny * nb[(size_t)(P_NORM + 1) * r_ext] +
                    gnz * nb[(size_t)(P_NORM + 2) * r_ext]) >= 0.9f;
        ok = ok && fabsf(depth - nb[(size_t)P_DEPTH * r_ext]) <= depth * 0.1f;
        ok = ok && !bad_weight(wgt);
        if (ok) {
          nq[i] = q;
          m = nb[(size_t)P_M * r_ext];
        }
      }
      // cums[i] = w_0 + ... + w_i (the last one is the aggregate weight)
      a_weight = i == 0 ? (ok ? wgt : 0.0f) : a_weight + (ok ? wgt : 0.0f);
      a_m = i == 0 ? m : a_m + m;
      cums[i] = a_weight;
    }

    uint32_t h[4];
    const uint32_t pg = (uint32_t)(pix0 + p);  // the global pixel
    pcg4d(pg, looper, (uint32_t)CTR_SPATIAL, SALT_RESTIR, h);
    const float thresh = unit(h[0]) * a_weight;
    pcg4d(pg, looper, (uint32_t)(CTR_SPATIAL + neighbors),
          SALT_RESTIR, h);
    const float r_s = unit(h[0]);
    int jsel = 0;
#pragma unroll
    for (int j = 0; j < MAX_N - 1; ++j)
      if (j < neighbors - 1 && cums[j] <= thresh) ++jsel;
    int qsel = -1;
#pragma unroll
    for (int j = 0; j < MAX_N; ++j)
      if (j == jsel) qsel = nq[j];
    float a_li[3] = {0.0f, 0.0f, 0.0f}, a_wi[3] = {0.0f, 0.0f, 0.0f};
    if (a_weight > 0.0f && qsel >= 0) {
      const float* nb = pt_ext + qsel;
      a_li[0] = nb[(size_t)(P_LI + 0) * r_ext];
      a_li[1] = nb[(size_t)(P_LI + 1) * r_ext];
      a_li[2] = nb[(size_t)(P_LI + 2) * r_ext];
      a_wi[0] = nb[(size_t)(P_WI + 0) * r_ext];
      a_wi[1] = nb[(size_t)(P_WI + 1) * r_ext];
      a_wi[2] = nb[(size_t)(P_WI + 2) * r_ext];
    }
    // merge(self, aggregate) (restir.cu:205-210)
    if (!bad_weight(a_weight) && !bad_weight(r_weight) && shade) {
      const float w_new = r_weight + a_weight;
      if (r_s * w_new < a_weight) {
        li[0] = a_li[0];
        li[1] = a_li[1];
        li[2] = a_li[2];
        wi[0] = a_wi[0];
        wi[1] = a_wi[1];
        wi[2] = a_wi[2];
      }
      r_weight = w_new;
      r_m = r_m + a_m;
    }
  }

  // ---- shade (restir.cu:216-230): demodulated BSDF, modulated by albedo
  const float mtype = G(G_MTYPE);
  const float wox = -G(G_DIR), woy = -G(G_DIR + 1), woz = -G(G_DIR + 2);
  const float sgn =
      (mtype != 2.0f && (gnx * wox + gny * woy + gnz * woz) < 0.0f) ? -1.0f
                                                                    : 1.0f;
  const float f_lum =
      bsdf_lum(mtype, G(G_METAL), G(G_ROUGH), gnx * sgn, gny * sgn, gnz * sgn,
               wox, woy, woz, wi[0], wi[1], wi[2], has_met);
  const float li_lum = 0.2126f * li[0] + 0.7152f * li[1] + 0.0722f * li[2];
  const float w_big = r_weight / fmaxf(r_m, 1.0f);
  float scale = w_big / fmaxf(li_lum, 1e-20f);
  const bool live =
      shade && !bad_weight(r_weight) && f_lum > 0.0f && li_lum > 0.0f;
  scale = live ? scale : 0.0f;
  const bool one = G(G_LIGHT) > 0.5f || G(G_MISS) > 0.5f;
  const float it = (float)iteration;
  const float inv = 1.0f / (it + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = li[c] * scale;
    v = (isnan(v) || isinf(v)) ? 0.0f : v;
    v = one ? 1.0f : v;
    v = v * G(G_ALB + c);
    float* a = accum + (size_t)c * r + p;
    if (accumulate) v = (*a * it + v) * inv;
    *a = v;
  }
}

}  // namespace

// pt_ext: the pt pack the neighbours are read from, r_ext pixels (pt
// itself on a whole frame: r_ext = r); pix0: the first global pixel of
// gb / pt / accum (0 on a whole frame).
extern "C" int restir_spatial_shade(const int* offs, const float* gb,
                                    const float* pt, const float* pt_ext,
                                    float* accum, int r, int r_ext,
                                    int width, int height, int pix0,
                                    uint32_t looper, int iteration,
                                    int neighbors, int flags, void* stream) {
  if (neighbors < 1 || neighbors > MAX_N || r <= 0 || r % TILE != 0 ||
      r_ext < r || pix0 < 0)
    return (int)cudaErrorInvalidValue;
  const int block = 256;
  spatial_shade_kernel<<<(r + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(
      offs, gb, pt, pt_ext, accum, r, r_ext, width, height, pix0, looper,
      iteration, neighbors, flags);
  return (int)cudaGetLastError();
}
