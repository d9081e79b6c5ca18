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
// where the history is over 3.5 frames, else the 3x3 spatial one, and
// with it level 0's prefilter of that variance. svgf_filter_variance_kernel
// replaces svgf_filter_variance (filterVariance, denoiser.cu:345-371): a
// 3x3 Gaussian of the variance, run before wavelet levels 1-4. On the TPU
// both were XLA plane shifts.
//
// Both variance passes run 2-D blocks over 32x32-pixel tiles, 4 rows per
// thread: a thread's x and y come from its block and thread indices, with
// no division by the width, and each block stages its tile and halo in
// shared memory by row loads (a flat index over the staged rows; its
// division is by a constant). The variance kernel stages the moments
// E[lum] and E[lum^2] with a 2-pixel halo and the history with a 1-pixel
// one, computes the variance on the tile and a 1-pixel ring around it,
// and writes the tile's variance and its 3x3 Gaussian: one launch in
// place of an estimate and a level-0 prefilter that read the plane back.
// It reads the three moment planes through a base pointer, a channel
// stride and a pixel stride, so the fused path passes B5's pack and the
// general path its [R, 3] history with no copy. Out-of-frame neighbours
// are skipped, never added as zero; ragged tiles are masked; pixels whose
// taps all lie in the frame skip the bounds tests.
//
// Bound: device memory. B5 reads 3 colour + 10 gb + 10 history floats
// and writes 16 per pixel; the variance kernel reads 3 floats and writes
// 2, a prefilter reads 1 and writes 1. Their arithmetic is a few dozen
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

// The variance passes' blocks: VB_W x VB_H threads over a tile of VB_W x
// T_H pixels, VB_ROWS rows per thread (a 1080p frame is ~2 waves of
// tiles, not 8 waves of 32x8 tiles that each wait out their loads). The
// staged tiles: the variance kernel's moments with a 2-pixel halo, its
// history and variance with a 1-pixel ring, the prefilter's variance
// with a 1-pixel halo.
enum { VB_W = 32, VB_H = 8, VB_N = VB_W * VB_H, VB_ROWS = 4 };
enum { T_H = VB_H * VB_ROWS };
enum { M_W = VB_W + 4, M_H = T_H + 4, V_W = VB_W + 2, V_H = T_H + 2 };

// The 3x3 Gaussian's weight at tap (i, j) (denoiser.cu:19-23): with the
// loops unrolled, an immediate operand, and the weight sum of an inner
// pixel a constant.
__device__ __forceinline__ constexpr float gauss3_w(int i, int j) {
  return i == 0 && j == 0 ? 0.204f : (i == 0 || j == 0 ? 0.124f : 0.075f);
}

// Whether all 3x3 taps of frame pixel (gx, gy) lie in the frame: such a
// pixel sums every tap without a bounds test, in the same order, so its
// sums round as the checked path's (its tap count is 9 and its weight
// sum a constant that the compiler folds).
__device__ __forceinline__ bool inner3(int gx, int gy, int width,
                                       int height) {
  return gx > 0 && gx < width - 1 && gy > 0 && gy < height - 1;
}

// filterVariance at frame pixel (gx, gy), whose staged value sits at
// s[cy][cx]: the in-frame taps in the twin's order (i outer, j inner).
template <bool INNER>
__device__ __forceinline__ float gauss3_taps(const float (*s)[V_W], int cx,
                                             int cy, int gx, int gy,
                                             int width, int height) {
  float acc = 0.0f, sw = 0.0f;
#pragma unroll
  for (int i = -1; i <= 1; ++i) {
    const int yy = gy + i;
    if (!INNER && (yy < 0 || yy >= height)) continue;
#pragma unroll
    for (int j = -1; j <= 1; ++j) {
      const int xx = gx + j;
      if (!INNER && (xx < 0 || xx >= width)) continue;
      const float g = gauss3_w(i, j);
      acc = __fadd_rn(acc, __fmul_rn(s[cy + i][cx + j], g));
      sw = __fadd_rn(sw, g);
    }
  }
  return __fdiv_rn(acc, fmaxf(sw, 1e-20f));
}

__device__ __forceinline__ float gauss3(const float (*s)[V_W], int cx,
                                        int cy, int gx, int gy, int width,
                                        int height) {
  return inner3(gx, gy, width, height)
             ? gauss3_taps<true>(s, cx, cy, gx, gy, width, height)
             : gauss3_taps<false>(s, cx, cy, gx, gy, width, height);
}

// estimateVariance at frame pixel (gx, gy) from the staged moments, whose
// value for the pixel sits at s1 / s2[my][mx], and its history h: the 3x3
// moment sums over the in-frame taps in the twin's order, then the
// temporal variance where the history is over 3.5 frames, else the
// spatial one.
template <bool INNER>
__device__ __forceinline__ float variance_at(const float (*s1)[M_W],
                                             const float (*s2)[M_W], int mx,
                                             int my, float h, int gx, int gy,
                                             int width, int height) {
  float a1 = 0.0f, a2 = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int i = -1; i <= 1; ++i) {
    const int yy = gy + i;
    if (!INNER && (yy < 0 || yy >= height)) continue;
#pragma unroll
    for (int j = -1; j <= 1; ++j) {
      const int xx = gx + j;
      if (!INNER && (xx < 0 || xx >= width)) continue;
      a1 = __fadd_rn(a1, s1[my + i][mx + j]);
      a2 = __fadd_rn(a2, s2[my + i][mx + j]);
      cnt = __fadd_rn(cnt, 1.0f);
    }
  }
  const float mean = __fdiv_rn(a1, cnt);
  const float spatial = __fsub_rn(__fdiv_rn(a2, cnt), __fmul_rn(mean, mean));
  const float c1 = s1[my][mx];
  const float temporal = __fsub_rn(s2[my][mx], __fmul_rn(c1, c1));
  return h > 3.5f ? temporal : spatial;
}

// m: moment c of pixel p at m[c * cs + p * ps] (E[lum], E[lum^2],
// history). Writes var and its level-0 prefilter fv, both [width x
// height]. Every staging and ring pass runs over a flat index, so each
// pass is whole warps and its loads issue together.
__global__ void __launch_bounds__(VB_N) svgf_variance_kernel(
    const float* __restrict__ m, long long cs, long long ps,
    float* __restrict__ var, float* __restrict__ fv, int width,
    int height) {
  __shared__ float s1[M_H][M_W], s2[M_H][M_W], sh[V_H][V_W], sv[V_H][V_W];
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * VB_W + tx;
  const int x0 = (int)blockIdx.x * VB_W, y0 = (int)blockIdx.y * T_H;
#pragma unroll
  for (int k = t; k < M_H * M_W; k += VB_N) {
    const int sy = k / M_W, sx = k - sy * M_W;
    const int gx = x0 + sx - 2, gy = y0 + sy - 2;
    float a = 0.0f, b = 0.0f;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height) {
      const float* q = m + ((long long)gy * width + gx) * ps;
      a = q[0];
      b = q[cs];
    }
    s1[sy][sx] = a;
    s2[sy][sx] = b;
  }
#pragma unroll
  for (int k = t; k < V_H * V_W; k += VB_N) {
    const int sy = k / V_W, sx = k - sy * V_W;
    const int gx = x0 + sx - 1, gy = y0 + sy - 1;
    sh[sy][sx] = gx >= 0 && gx < width && gy >= 0 && gy < height
                     ? m[((long long)gy * width + gx) * ps + 2 * cs]
                     : 0.0f;
  }
  __syncthreads();
  // the variance on the tile and its ring (ring pixels off the frame are
  // never read)
  for (int k = t; k < V_H * V_W; k += VB_N) {
    const int vy = k / V_W, vx = k - vy * V_W;
    const int gx = x0 + vx - 1, gy = y0 + vy - 1;
    float v = 0.0f;
    if (inner3(gx, gy, width, height))
      v = variance_at<true>(s1, s2, vx + 1, vy + 1, sh[vy][vx], gx, gy,
                            width, height);
    else if (gx >= 0 && gx < width && gy >= 0 && gy < height)
      v = variance_at<false>(s1, s2, vx + 1, vy + 1, sh[vy][vx], gx, gy,
                             width, height);
    sv[vy][vx] = v;
  }
  __syncthreads();
  const int gx = x0 + tx;
#pragma unroll
  for (int rr = 0; rr < VB_ROWS; ++rr) {
    const int ly = ty + rr * VB_H, gy = y0 + ly;
    if (gx < width && gy < height) {
      const int p = gy * width + gx;
      var[p] = sv[ly + 1][tx + 1];
      fv[p] = gauss3(sv, tx + 1, ly + 1, gx, gy, width, height);
    }
  }
}

__global__ void __launch_bounds__(VB_N) svgf_filter_variance_kernel(
    const float* __restrict__ var, float* __restrict__ out, int width,
    int height) {
  __shared__ float sv[V_H][V_W];
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * VB_W + tx;
  const int x0 = (int)blockIdx.x * VB_W, y0 = (int)blockIdx.y * T_H;
#pragma unroll
  for (int k = t; k < V_H * V_W; k += VB_N) {
    const int sy = k / V_W, sx = k - sy * V_W;
    const int gx = x0 + sx - 1, gy = y0 + sy - 1;
    sv[sy][sx] = gx >= 0 && gx < width && gy >= 0 && gy < height
                     ? var[gy * width + gx]
                     : 0.0f;
  }
  __syncthreads();
  const int gx = x0 + tx;
#pragma unroll
  for (int rr = 0; rr < VB_ROWS; ++rr) {
    const int ly = ty + rr * VB_H, gy = y0 + ly;
    if (gx < width && gy < height)
      out[gy * width + gx] =
          gauss3(sv, tx + 1, ly + 1, gx, gy, width, height);
  }
}

inline bool variance_grid(int width, int height, dim3& grid) {
  if (width <= 0 || height <= 0 || (long long)width * height > 0x7fffffff)
    return false;
  grid = dim3((width + VB_W - 1) / VB_W, (height + T_H - 1) / T_H);
  return grid.y <= 65535;
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

// m: the moments E[lum], E[lum^2], history, moment c of pixel p at
// m[c * cs + p * ps]. Writes var and its level-0 prefilter fv, float32
// [width x height] each.
extern "C" int restir_svgf_variance(const float* m, long long cs,
                                    long long ps, float* var, float* fv,
                                    int width, int height, void* stream) {
  dim3 grid;
  if (!variance_grid(width, height, grid) || cs < 0 || ps < 0)
    return (int)cudaErrorInvalidValue;
  svgf_variance_kernel<<<grid, dim3(VB_W, VB_H), 0, (cudaStream_t)stream>>>(
      m, cs, ps, var, fv, width, height);
  return (int)cudaGetLastError();
}

extern "C" int restir_svgf_filter_variance(const float* var, float* out,
                                           int width, int height,
                                           void* stream) {
  dim3 grid;
  if (!variance_grid(width, height, grid)) return (int)cudaErrorInvalidValue;
  svgf_filter_variance_kernel<<<grid, dim3(VB_W, VB_H), 0,
                                (cudaStream_t)stream>>>(var, out, width,
                                                        height);
  return (int)cudaGetLastError();
}
