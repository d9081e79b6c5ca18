// Shared device code of the port's kernels: pack channel layouts, the
// pcg4d counter RNG, the temporal window start of a tile and the
// demodulated BSDF luminance.
//
// Everything here mirrors restir_tpu (utils/rng.py, ops/pallas/fused_di.py
// channel constants, ops/pallas/ris_kernel.py::_eval_bsdf_lum) in float32
// with IEEE division and square root: the build passes no fast-math flag.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace restir {

// ---- gb pack channels ([GB_CH, R]) ----
enum {
  G_POS = 0, G_NORM = 3, G_DIR = 6, G_ALB = 9, G_DEPTH = 12, G_MOTION = 13,
  G_PRIMR = 14, G_MTYPE = 15, G_METAL = 16, G_ROUGH = 17, G_SHADE = 18,
  G_LIGHT = 19, G_MISS = 20, G_PRIM = 21, G_X = 22, G_Y = 23, GB_CH = 24
};

// ---- pt (reuse) pack channels ([PT_CH, R]) ----
enum {
  P_LI = 0, P_WI = 3, P_DIST = 6, P_WEIGHT = 7, P_M = 8, P_PRIMR = 9,
  P_NORM = 10, P_DEPTH = 13, PT_CH = 16
};

// ---- rs pack between the two B1 launches ([RS_CH, R]) ----
enum { RS_LI = 0, RS_WI = 3, RS_DIST = 6, RS_W = 7, RS_CH = 8 };

enum { SALT_CAMERA = 0x01, SALT_RESTIR = 0x02 };
enum { CTR_TEMPORAL = 0, CTR_SPATIAL = 1, CTR_RIS = 8 };
enum { TILE = 1024 };

#define RESTIR_BIG 3.0e38f
#define RESTIR_PI 3.14159265358979f
#define RESTIR_INV_PI 0.31830988618379069f  // float(1 / 3.14159265358979)

// PCG4D hash (Jarzynski & Olano 2020), utils/rng.py::pcg4d.
__device__ __forceinline__ void pcg4d(uint32_t a, uint32_t b, uint32_t c,
                                      uint32_t d, uint32_t out[4]) {
  uint32_t vx = a * 1664525u + 1013904223u;
  uint32_t vy = b * 1664525u + 1013904223u;
  uint32_t vz = c * 1664525u + 1013904223u;
  uint32_t vw = d * 1664525u + 1013904223u;
  vx += vy * vw;
  vy += vz * vx;
  vz += vx * vy;
  vw += vy * vz;
  vx ^= vx >> 16;
  vy ^= vy >> 16;
  vz ^= vz >> 16;
  vw ^= vw >> 16;
  vx += vy * vw;
  vy += vz * vx;
  vz += vx * vy;
  vw += vy * vz;
  out[0] = vx;
  out[1] = vy;
  out[2] = vz;
  out[3] = vw;
}

// Top 24 bits -> [0, 1) (exact in float32).
__device__ __forceinline__ float unit(uint32_t bits) {
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ bool bad_weight(float w) {
  return isnan(w) || isinf(w) || w < 0.0f;
}

// Start of the temporal window of a 1024-pixel tile
// (fused_di._window_start): the minimum valid motion index over the tile
// (miss pixels carry motion 0 and are excluded), rounded down to 128 and
// clamped so [w0, w0 + window) stays inside the previous pack of r_prev
// pixels. Every thread of a TILE-thread block calls it with its own
// pixel's motion, rebased to the previous pack's first pixel.
__device__ __forceinline__ int tile_window_start(float motion, bool miss,
                                                 int r_prev, int window) {
  __shared__ float warp_min[TILE / 32];
  __shared__ int w0_s;
  float mv = (motion >= 0.0f && !miss) ? motion : (float)r_prev;
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
      w0 = min(max(w0, 0), max(r_prev - window, 0));
      w0_s = w0;
    }
  }
  __syncthreads();
  return w0_s;
}

// A motion index rebased to the previous pack's first global pixel
// prev_base (0 for a whole frame; a row band's haloed pack starts a
// window before the band): negative markers stay as they are.
__device__ __forceinline__ float rebase_motion(float motion, int prev_base) {
  return motion >= 0.0f ? __fsub_rn(motion, (float)prev_base) : motion;
}

// 2-D pixel tiles (B6, B7): a block of PIX_BLOCK threads covers
// PIX_BW x PIX_BH pixels and each warp PIX_WW x PIX_WH, so a warp's rays
// leave from one small patch of the image and each channel store is four
// 32-byte segments. The tiles cover the rows of a band of r pixels from
// global pixel pix0 (a whole frame: pix0 = 0, r = width x height), which
// may start and end mid-row. Launch PIX_BLOCK threads on
// tile_grid(width, pix0, r). Returns the global pixel index, or -1 off
// the ragged edge or outside the band (the map of
// ops/kernels/gbuffer.py::tile_order).
enum { PIX_BLOCK = 256, PIX_BW = 32, PIX_BH = 8, PIX_WW = 8, PIX_WH = 4 };

__device__ __forceinline__ int tile_pixel(int width, int pix0, int r) {
  const int warp = (int)threadIdx.x >> 5, lane = (int)threadIdx.x & 31;
  const int x = (int)blockIdx.x * PIX_BW +
                (warp % (PIX_BW / PIX_WW)) * PIX_WW + lane % PIX_WW;
  const int y = pix0 / width + (int)blockIdx.y * PIX_BH +
                (warp / (PIX_BW / PIX_WW)) * PIX_WH + lane / PIX_WW;
  const int g = y * width + x;
  return (x < width && g >= pix0 && g < pix0 + r) ? g : -1;
}

inline dim3 tile_grid(int width, int pix0, int r) {
  const int rows = (pix0 + r - 1) / width - pix0 / width + 1;
  return dim3((width + PIX_BW - 1) / PIX_BW, (rows + PIX_BH - 1) / PIX_BH);
}

// Streams the n_rows 64-byte rows of a table in device memory (4 float4
// a row) through shared memory, blockDim.x / 4 rows at a time, for light
// tables too large to stage whole (the light search of B7 and B10). buf
// holds 2 * blockDim.x float4: while a chunk is scanned from one half,
// each thread holds its float4 of the next chunk in a register, and
// stores it into the other half after the scan, so one barrier a chunk
// separates both. scan(rows, l0, n) reads rows l0 .. l0 + n - 1 at
// rows[4 * (l - l0)]. Every thread of the block must call this, the same
// number of times with the same n_rows: a thread with nothing to scan
// (off the frame) still stages and waits at each barrier.
template <class Scan>
__device__ __forceinline__ void stream_rows(const float4* __restrict__ rows,
                                            int n_rows, float4* buf,
                                            Scan&& scan) {
  const int t = (int)threadIdx.x, n4 = 4 * n_rows;
  const int step = (int)blockDim.x;  // float4 a chunk
  if (t < n4) buf[t] = __ldg(rows + t);
  __syncthreads();
  for (int i0 = 0, half = 0; i0 < n4; i0 += step, half ^= step) {
    const int nx = i0 + step + t;
    const float4 next =
        nx < n4 ? __ldg(rows + nx) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    scan(buf + half, i0 / 4, min(step, n4 - i0) / 4);
    buf[(half ^ step) + t] = next;
    __syncthreads();
  }
}

// Luminance of the demodulated BSDF (base colour 1): Lambert, GGX
// metallic workflow, dielectric -> 0 (delta). has_met = 0 drops the GGX
// chain for scenes without metallic materials.
__device__ __forceinline__ float bsdf_lum(float mtype, float metallic,
                                          float roughness, float nx, float ny,
                                          float nz, float wox, float woy,
                                          float woz, float wix, float wiy,
                                          float wiz, int has_met) {
  if (mtype == 0.0f) return RESTIR_INV_PI;
  if (!has_met || mtype != 1.0f) return 0.0f;
  const float cos_o = nx * wox + ny * woy + nz * woz;
  const float cos_i = nx * wix + ny * wiy + nz * wiz;
  float hx = wox + wix, hy = woy + wiy, hz = woz + wiz;
  const float hl = fmaxf(sqrtf(hx * hx + hy * hy + hz * hz), 1e-20f);
  hx = hx / hl;
  hy = hy / hl;
  hz = hz / hl;
  const float alpha = roughness * roughness;
  const float cos_h = nx * hx + ny * hy + nz * hz;
  const float hdoto = hx * wox + hy * woy + hz * woz;
  const float aa = alpha * alpha;
  const float denom = cos_h * cos_h * (aa - 1.0f) + 1.0f;
  const float d_ggx =
      cos_h < 1e-6f ? 0.0f : aa / fmaxf(denom * denom * RESTIR_PI, 1e-20f);
  const float a_half = alpha * 0.5f;
  const float co = fabsf(cos_o), ci = fabsf(cos_i);
  const float g = co / fmaxf(co * (1.0f - a_half) + a_half, 1e-20f) *
                  (ci / fmaxf(ci * (1.0f - a_half) + a_half, 1e-20f));
  const float f0 = 0.08f * (1.0f - metallic) + metallic;
  const float one_m = 1.0f - hdoto;
  float p5 = one_m * one_m;
  p5 = p5 * p5 * one_m;
  const float fr = f0 * (1.0f - p5) + p5;
  const float spec = g * d_ggx / fmaxf(4.0f * cos_i * cos_o, 1e-20f);
  const float diffuse = RESTIR_INV_PI * (1.0f - metallic);
  const float met = diffuse * (1.0f - fr) + spec * fr;
  return cos_i * cos_o >= 1e-7f ? met : 0.0f;
}

}  // namespace restir
