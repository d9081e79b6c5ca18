// SVGF on the fused DI frame: kernel B5 (temporal accumulation) and the
// two variance passes that feed the variance-guided wavelet levels (B4,
// atrous.cu).
//
// B5 replaces restir_tpu/ops/pallas/fused_di.py::_svgf_temporal_kernel
// (svgf_temporal_pallas; temporalAccumulate, denoiser.cu:250-305). One
// 1024-thread block per 1024-pixel tile: the tile's temporal window start
// (tile_window_start, common.cuh, shared with B1b), then per pixel the
// previous svgf pack's column at the motion index, the disocclusion test
// (outside the window, NULL prim, prim mismatch, |n.n'| < 0.1) and the
// alpha = 0.2 blend of colour and of the (lum, lum^2) moments. The window
// keeps the TPU kernel's deviation: a history pixel outside
// [w0, w0 + window) reads as a disocclusion (2048 pixels on a whole
// frame; a row band reads its haloed pack, rebased as in B1b).
//
// svgf_variance_kernel replaces models/denoiser.py::svgf_estimate_variance
// (estimateVariance, denoiser.cu:307-343): the temporal moment variance
// where the history is over 3.5 frames, else the 3x3 spatial one.
// svgf_filter_variance_kernel replaces svgf_filter_variance
// (filterVariance, denoiser.cu:345-371): a 3x3 Gaussian of the variance,
// run before each wavelet level. On the TPU both were XLA plane shifts.
//
// Bound: device memory. B5 reads 3 colour + 10 gb + 10 history floats
// and writes 16 per pixel; the variance passes read 3 (or 1) floats and
// 9 neighbours (from cache) and write 1. Their arithmetic is a few dozen
// operations per pixel, far under the bytes' time.
//
// Every multiply and add is written with a round-to-nearest intrinsic
// (no FMA contraction), so each value rounds as the plain PyTorch twin's
// (ops/kernels/svgf.py, models/denoiser.py) does.
#include "common.cuh"

using namespace restir;

namespace {

enum {
  SV_COL = 0, SV_M1 = 3, SV_M2 = 4, SV_HIST = 5, SV_PRIM = 6, SV_NORM = 7,
  SV_CH = 16
};

__device__ __forceinline__ float lum(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.2126f, r), __fmul_rn(0.7152f, g)),
                   __fmul_rn(0.0722f, b));
}

// l + (c - l) * alpha (mathx.mix)
__device__ __forceinline__ float mix(float l, float c, float a) {
  return __fadd_rn(l, __fmul_rn(__fsub_rn(c, l), a));
}

__global__ void __launch_bounds__(TILE) svgf_temporal_kernel(
    const float* __restrict__ gb, const float* __restrict__ color,
    const float* __restrict__ prev, float* __restrict__ out, int r,
    int r_prev, int prev_base, int window) {
  const int p = blockIdx.x * TILE + threadIdx.x;
  const float* g = gb + p;
  const float motion = rebase_motion(g[(size_t)G_MOTION * r], prev_base);
  const bool miss = g[(size_t)G_MISS * r] > 0.5f;
  const int w0 = tile_window_start(motion, miss, r_prev, window);

  const float prim = g[(size_t)G_PRIMR * r];
  const float gnx = g[(size_t)(G_NORM + 0) * r];
  const float gny = g[(size_t)(G_NORM + 1) * r];
  const float gnz = g[(size_t)(G_NORM + 2) * r];
  const float cx = color[p], cy = color[(size_t)r + p],
              cz = color[(size_t)2 * r + p];
  const float l = lum(cx, cy, cz);

  const int mot = __float2int_rz(motion);
  const int rel = mot - w0;
  const bool in_win = mot >= 0 && rel >= 0 && rel < window && mot < r_prev;
  const float* h = prev + (in_win ? mot : w0);
  const float l_prim = h[(size_t)SV_PRIM * r_prev];
  const float ndot = __fadd_rn(
      __fadd_rn(__fmul_rn(gnx, h[(size_t)(SV_NORM + 0) * r_prev]),
                __fmul_rn(gny, h[(size_t)(SV_NORM + 1) * r_prev])),
      __fmul_rn(gnz, h[(size_t)(SV_NORM + 2) * r_prev]));
  const bool reset = !in_win || prim <= -1.0f || l_prim != prim ||
                     fabsf(ndot) < 0.1f;

  const float a = 0.2f;  // SVGF_ALPHA
  float* o = out + p;
  if (reset) {
    o[(size_t)(SV_COL + 0) * r] = cx;
    o[(size_t)(SV_COL + 1) * r] = cy;
    o[(size_t)(SV_COL + 2) * r] = cz;
    o[(size_t)SV_M1 * r] = l;
    o[(size_t)SV_M2 * r] = __fmul_rn(l, l);
    o[(size_t)SV_HIST * r] = 0.0f;
  } else {
    o[(size_t)(SV_COL + 0) * r] = mix(h[(size_t)(SV_COL + 0) * r_prev], cx, a);
    o[(size_t)(SV_COL + 1) * r] = mix(h[(size_t)(SV_COL + 1) * r_prev], cy, a);
    o[(size_t)(SV_COL + 2) * r] = mix(h[(size_t)(SV_COL + 2) * r_prev], cz, a);
    o[(size_t)SV_M1 * r] = mix(h[(size_t)SV_M1 * r_prev], l, a);
    o[(size_t)SV_M2 * r] = mix(h[(size_t)SV_M2 * r_prev], __fmul_rn(l, l), a);
    o[(size_t)SV_HIST * r] = __fadd_rn(h[(size_t)SV_HIST * r_prev], 1.0f);
  }
  o[(size_t)SV_PRIM * r] = prim;
  o[(size_t)(SV_NORM + 0) * r] = gnx;
  o[(size_t)(SV_NORM + 1) * r] = gny;
  o[(size_t)(SV_NORM + 2) * r] = gnz;
  for (int c = SV_NORM + 3; c < SV_CH; ++c) o[(size_t)c * r] = 0.0f;
}

__global__ void __launch_bounds__(256) svgf_variance_kernel(
    const float* __restrict__ sv, float* __restrict__ var, int width,
    int height) {
  const int r = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  const int x = p % width, y = p / width;
  const float* m1 = sv + (size_t)SV_M1 * r;
  const float* m2 = sv + (size_t)SV_M2 * r;
  float s1 = 0.0f, s2 = 0.0f, cnt = 0.0f;
  for (int i = -1; i <= 1; ++i) {
    const int yy = y + i;
    if (yy < 0 || yy >= height) continue;
    for (int j = -1; j <= 1; ++j) {
      const int xx = x + j;
      if (xx < 0 || xx >= width) continue;
      const int q = yy * width + xx;
      s1 = __fadd_rn(s1, m1[q]);
      s2 = __fadd_rn(s2, m2[q]);
      cnt = __fadd_rn(cnt, 1.0f);
    }
  }
  const float mean = __fdiv_rn(s1, cnt);
  const float spatial = __fsub_rn(__fdiv_rn(s2, cnt), __fmul_rn(mean, mean));
  const float temporal = __fsub_rn(m2[p], __fmul_rn(m1[p], m1[p]));
  var[p] = sv[(size_t)SV_HIST * r + p] > 3.5f ? temporal : spatial;
}

__constant__ float kGauss3[9] = {0.075f, 0.124f, 0.075f, 0.124f, 0.204f,
                                 0.124f, 0.075f, 0.124f, 0.075f};

__global__ void __launch_bounds__(256) svgf_filter_variance_kernel(
    const float* __restrict__ var, float* __restrict__ out, int width,
    int height) {
  const int r = width * height;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  const int x = p % width, y = p / width;
  float s = 0.0f, sw = 0.0f;
  for (int i = -1; i <= 1; ++i) {
    const int yy = y + i;
    if (yy < 0 || yy >= height) continue;
    for (int j = -1; j <= 1; ++j) {
      const int xx = x + j;
      if (xx < 0 || xx >= width) continue;
      const float g = kGauss3[(i + 1) * 3 + (j + 1)];
      s = __fadd_rn(s, __fmul_rn(var[yy * width + xx], g));
      sw = __fadd_rn(sw, g);
    }
  }
  out[p] = __fdiv_rn(s, fmaxf(sw, 1e-20f));
}

}  // namespace

// prev: the previous svgf pack of r_prev pixels from global pixel
// prev_base (a whole frame: r_prev = r, prev_base = 0; a row band's pack
// with its +-window halos), window: the temporal window, a multiple of
// TILE.
extern "C" int restir_svgf_temporal(const float* gb, const float* color,
                                    const float* prev, float* out, int r,
                                    int r_prev, int prev_base, int window,
                                    void* stream) {
  if (r <= 0 || r % TILE != 0 || r_prev <= 0 || window <= 0 ||
      window % TILE != 0)
    return (int)cudaErrorInvalidValue;
  svgf_temporal_kernel<<<r / TILE, TILE, 0, (cudaStream_t)stream>>>(
      gb, color, prev, out, r, r_prev, prev_base, window);
  return (int)cudaGetLastError();
}

extern "C" int restir_svgf_variance(const float* sv, float* var, int width,
                                    int height, void* stream) {
  const int r = width * height;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  svgf_variance_kernel<<<(r + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(sv, var, width, height);
  return (int)cudaGetLastError();
}

extern "C" int restir_svgf_filter_variance(const float* var, float* out,
                                           int width, int height,
                                           void* stream) {
  const int r = width * height;
  if (r <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  svgf_filter_variance_kernel<<<(r + block - 1) / block, block, 0,
                                (cudaStream_t)stream>>>(var, out, width,
                                                        height);
  return (int)cudaGetLastError();
}
