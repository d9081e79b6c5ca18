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
// SM that the launch bounds ask for (b7_seg below; mirrored on the host
// by ops/kernels/reuse.py, seg_for): 8 on the hall's 128 lights (24 KB
// per block), 16 on its 640 rows under a sky (58 KB, against the first
// design's 80 KB of psi and light rows; the K picked light rows are read
// through the read-only path). Once the search was cheap, the walk took
// most of the time: it waits out chains of dependent node loads, so the
// registers are capped for more warps per SM (launch bounds below), and
// its leaf test reads plane rows as float4 (PlaneRay4). Its warps are 8x4
// pixel tiles of the frame (common.cuh, tile_pixel), though each pixel
// shoots at its own random light, so tiles help it little.
//
// With an env map (template flag HAS_ENV) the 512 env tiles follow the
// area lights as virtual lights, and an env winner's shadow ray runs to
// RESTIR_ENV_DIST.
#include "bvh.cuh"
#include "di_core.cuh"
#if defined(PROBE_WALK)
#include "prof/walk_probe.cuh"  // stage probes (restir_tpu_torch/prof)
#endif

using namespace restir;

namespace {

constexpr int kEnvRows = RESTIR_ENV_TH * RESTIR_ENV_TW;

// ---- B7's RIS: di_core.cuh's ris_select with the search below ----
//
// ris_select's light targets and frame are plain expressions whose FMA
// fusion nvcc chooses; here they are spelled out with intrinsics as nvcc
// fused them in the first B1 and B7 builds (read from their SASS; the CPU
// mirror is ops/kernels/reuse.py), so the search's two scans and the
// full scan round alike. Left to the compiler, this code fused the frame
// otherwise and moved B7's packs. ris_finish repeats ris_select's
// candidate evaluation and winner: B1 and B10 keep their inline copy, as
// sharing the evaluation slowed B1's env build by 5 % and sharing the
// winner moved B1's texture build by an ulp (PERF.md §6). The B1 ==
// B6 + B7 + B1b tests named at di_core.cuh's light_target keep the two
// copies, and light_target with light_target4 / env_target, equal.

// The frame the light targets read: the normal facing wo (dielectrics
// keep theirs), n.p, |p|^2 and -2p.
struct RisFrame {
  float px, py, pz, nx, ny, nz, wox, woy, woz, ndx, x2, m2px, m2py, m2pz;
};

__device__ __forceinline__ RisFrame ris_frame(const Surface& s) {
  RisFrame f;
  f.px = s.px;
  f.py = s.py;
  f.pz = s.pz;
  f.wox = -s.dx;
  f.woy = -s.dy;
  f.woz = -s.dz;
  f.nx = s.nx;
  f.ny = s.ny;
  f.nz = s.nz;
  const float ndotwo = __fmaf_rn(
      s.nz, f.woz, __fmaf_rn(s.nx, f.wox, __fmul_rn(s.ny, f.woy)));
  if (s.mtype != 2.0f && ndotwo < 0.0f) {
    f.nx = -f.nx;
    f.ny = -f.ny;
    f.nz = -f.nz;
  }
  f.ndx = __fmaf_rn(f.nz, s.pz,
                    __fmaf_rn(f.ny, s.py, __fmul_rn(f.nx, s.px)));
  f.x2 = __fmaf_rn(s.pz, s.pz,
                   __fmaf_rn(s.px, s.px, __fmul_rn(s.py, s.py)));
  f.m2px = -2.0f * s.px;
  f.m2py = -2.0f * s.py;
  f.m2pz = -2.0f * s.pz;
  return f;
}

// di_core.cuh's light_target at frame f (the same value), reading the
// psi row as four float4.
__device__ __forceinline__ float light_target4(const float4* ps4,
                                               const RisFrame& f,
                                               int single_sided) {
  const float4 p0 = ps4[0], p1 = ps4[1], p2 = ps4[2], p3 = ps4[3];
  const float a = __fmaf_rn(
      p0.w, -f.ndx,
      __fmaf_rn(p0.z, f.nz, __fmaf_rn(p0.x, f.nx, __fmul_rn(p0.y, f.ny))));
  const float bb = __fadd_rn(
      __fmaf_rn(p1.z, f.pz, __fmaf_rn(p1.x, f.px, __fmul_rn(p1.y, f.py))),
      p1.w);
  float d2 = __fmaf_rn(
      p3.x, f.x2,
      __fadd_rn(__fmaf_rn(p2.z, f.m2pz,
                          __fmaf_rn(p2.x, f.m2px, __fmul_rn(p2.y, f.m2py))),
                p2.w));
  d2 = fmaxf(d2, 1e-8f);
  const bool side = single_sided ? bb > 0.0f : fabsf(bb) > 0.0f;
  const float rad = p3.z;
  const bool above = __fadd_rn(a, rad) > 0.0f;
  const float a_eff = fmaxf(a, __fmul_rn(0.1f, rad));
  return (above && side) ? __fdiv_rn(__fmul_rn(__fmul_rn(p3.y, a_eff),
                                               fabsf(bb)),
                                     __fmul_rn(d2, d2))
                         : 0.0f;
}

// The target of an env-tile row, psi (d, 0 | 0, 0, 0, 1 | 0, 0, 0, 1, 0 |
// lum, rad): b = 1 and d2 = 1, so light_target4 reduces to lum * max(n.d,
// 0.1 rad) above the horizon band, bit for bit (the dropped ps3 * -ndx
// adds a zero, 1 * x and x / 1 are exact, and side holds). e = (d, rad).
__device__ __forceinline__ float env_target(float4 e, float lum,
                                            const RisFrame& f) {
  const float a =
      __fmaf_rn(e.z, f.nz, __fmaf_rn(e.x, f.nx, __fmul_rn(e.y, f.ny)));
  const bool above = __fadd_rn(a, e.w) > 0.0f;
  return above ? __fmul_rn(lum, fmaxf(a, __fmul_rn(0.1f, e.w))) : 0.0f;
}

// The candidates' draws: thr_j = u1 * total, the sample uniforms r2, r3
// and the winner's r4 of candidate 0.
struct RisDraws {
  float thr[MAX_K], r2[MAX_K], r3[MAX_K], r4_0;
};

__device__ __forceinline__ RisDraws ris_draws(uint32_t pu, uint32_t looper,
                                              int k, float total) {
  RisDraws d;
  d.r4_0 = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    d.r2[j] = d.r3[j] = d.thr[j] = 0.0f;
    if (j < k) {
      uint32_t h[4];
      pcg4d(pu, looper, (uint32_t)(CTR_RIS + j), SALT_RESTIR, h);
      d.thr[j] = unit(h[0]) * total;
      d.r2[j] = unit(h[1]);
      d.r3[j] = unit(h[2]);
      if (j == 0) d.r4_0 = unit(h[3]);
    }
  }
  return d;
}

// The K candidates at the found rows idx_j (targets tq_j) and the
// single-draw winner, as in ris_select. lights: the [l_pad, 16] rows in
// global memory, read through the read-only path. Lanes without a winner
// get li = wi = 0, dist = 0. With HAS_ENV, rows from n_area on are env
// tiles: a pick there samples a uv-uniform direction in the tile with its
// exact solid-angle pdf, and its shadow ray runs to RESTIR_ENV_DIST.
template <bool HAS_ENV>
__device__ __forceinline__ Candidate ris_finish(
    const float* lights, int n_area, int k, int single_sided, int has_met,
    const Surface& s, const RisFrame& f, float total, const RisDraws& d,
    const int idx[MAX_K], const float tq[MAX_K]) {
  const float px = s.px, py = s.py, pz = s.pz;
  const float mtype = s.mtype;
  const float wox = f.wox, woy = f.woy, woz = f.woz;
  const float nx = f.nx, ny = f.ny, nz = f.nz;
  float w[MAX_K], cwi[MAX_K][3], cdist[MAX_K];
  const float total_safe = fmaxf(total, 1e-20f);
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    w[j] = 0.0f;
    cwi[j][0] = cwi[j][1] = cwi[j][2] = 0.0f;
    cdist[j] = 0.0f;
    if (j >= k) continue;
    const float* Lp = lights + idx[j] * 16;
    auto L = [&](int c) { return __ldg(Lp + c); };
    const float q = tq[j] / total_safe;
    float wix, wiy, wiz, pdf, dist;
    if (HAS_ENV && idx[j] >= n_area) {
      // env tile (u0, v0 | du | dv): uv-uniform point, to_sphere
      const float u_s = fadd(L(0), fmul(d.r2[j], L(3)));
      const float v_s = fadd(L(1), fmul(d.r3[j], L(6)));
      const float phi = fmul(u_s, 6.28318548f);  // float32(2 pi)
      const float th = fmul(v_s, 3.14159274f);
      const float st = sinf(th);
      wix = fmul(cosf(phi), st);
      wiy = cosf(th);
      wiz = fmul(sinf(phi), st);
      pdf = __fdiv_rn(q, fmaxf(fmul(fmul(fmul(L(3), L(6)), 19.7392082f),
                                    fmaxf(st, 1e-6f)),
                               1e-20f));
      pdf = (total > 0.0f && q > 0.0f) ? pdf : -1.0f;
      dist = RESTIR_ENV_DIST;
    } else {
      const float sr = sqrtf(fmaxf(d.r3[j], 0.0f));
      const float b_u = 1.0f - sr;
      const float b_v = d.r2[j] * sr;
      const float sx = L(0) + b_u * L(3) + b_v * L(6);
      const float sy = L(1) + b_u * L(4) + b_v * L(7);
      const float sz = L(2) + b_u * L(5) + b_v * L(8);
      const float tx = sx - px, ty = sy - py, tz = sz - pz;
      const float dist2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f);
      const float inv_dist = 1.0f / sqrtf(dist2);
      wix = tx * inv_dist;
      wiy = ty * inv_dist;
      wiz = tz * inv_dist;
      const float cos_l = L(9) * wix + L(10) * wiy + L(11) * wiz;
      pdf = q * dist2 / fmaxf(L(15) * fabsf(cos_l), 1e-20f);
      if (single_sided) pdf = cos_l <= -1e-6f ? pdf : -1.0f;
      pdf = (total > 0.0f && q > 0.0f) ? pdf : -1.0f;
      dist = dist2 * inv_dist;
    }
    const float f_lum = bsdf_lum(mtype, s.metallic, s.roughness, nx, ny, nz,
                                 wox, woy, woz, wix, wiy, wiz, has_met);
    const float li_lum = 0.2126f * L(12) + 0.7152f * L(13) + 0.0722f * L(14);
    const float cos_s = fmaxf(nx * wix + ny * wiy + nz * wiz, 0.0f);
    const float wj = li_lum * f_lum * cos_s / pdf;
    const bool bad = isnan(wj) || isinf(wj) || pdf <= 0.0f;
    w[j] = (bad || !s.shade) ? 0.0f : wj;
    cwi[j][0] = wix;
    cwi[j][1] = wiy;
    cwi[j][2] = wiz;
    cdist[j] = dist;
  }

  // single-draw winner over the cumulative candidate weights
  float c = w[0], cums[MAX_K];
#pragma unroll
  for (int j = 1; j < MAX_K; ++j) {
    cums[j - 1] = c;
    if (j < k) c += w[j];
  }
  Candidate out;
  out.r_weight = c;
  const float thresh = d.r4_0 * c;
  int jsel = 0;
#pragma unroll
  for (int j = 0; j < MAX_K - 1; ++j)
    if (j < k - 1 && cums[j] <= thresh) ++jsel;
  const bool gate = c > 0.0f && s.shade;
  out.li[0] = out.li[1] = out.li[2] = 0.0f;
  out.wi[0] = out.wi[1] = out.wi[2] = 0.0f;
  out.dist = 0.0f;
  int row = 0;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (gate && j == jsel) {
      row = idx[j];
      out.wi[0] = cwi[j][0];
      out.wi[1] = cwi[j][1];
      out.wi[2] = cwi[j][2];
      out.dist = cdist[j];
    }
  }
  // the winner's radiance, read again from its light row rather than
  // kept for every candidate (registers)
  if (gate) {
    const float* Lw = lights + row * 16;
    out.li[0] = __ldg(Lw + 12);
    out.li[1] = __ldg(Lw + 13);
    out.li[2] = __ldg(Lw + 14);
  }
  return out;
}

// The light rows in shared memory and this thread's cdf checkpoints.
struct LightStage {
  const float4* area;    // [n_area * 4] psi rows
  const float4* env;     // [n_env] (d_tile, rad)
  const float* env_lum;  // [n_env] luminance x solid angle (psi col 13)
  float* ck;             // checkpoint c of this thread at ck[c * stride]
  int stride, n_area, n_live, seg;  // seg: light rows per checkpoint
};

// Adds the targets of rows [l0, l1) to cdf in row order and calls
// visit(l, t, cdf) after each add.
template <bool HAS_ENV, class Visit>
__device__ __forceinline__ float scan_rows(const LightStage& st,
                                           const RisFrame& f,
                                           int single_sided, int l0, int l1,
                                           float cdf, Visit&& visit) {
  const int la = min(l1, st.n_area);
  for (int l = l0; l < la; ++l) {
    const float t = light_target4(st.area + 4 * l, f, single_sided);
    cdf = __fadd_rn(cdf, t);
    visit(l, t, cdf);
  }
  if (HAS_ENV) {
    for (int l = max(l0, st.n_area); l < l1; ++l) {
      const int e = l - st.n_area;
      const float t = env_target(st.env[e], st.env_lum[e], f);
      cdf = __fadd_rn(cdf, t);
      visit(l, t, cdf);
    }
  }
  return cdf;
}

// The search (module note), then ris_finish. evaluated counts the light
// targets computed (COUNT builds).
template <bool COUNT, bool HAS_ENV>
__device__ __forceinline__ Candidate ris_select_seg(
    const LightStage& st, const float* lights, int l_pad, uint32_t pu,
    uint32_t looper, int k, int single_sided, int has_met, const Surface& s,
    int& evaluated) {
  const RisFrame f = ris_frame(s);
  const int n_seg = (st.n_live + st.seg - 1) / st.seg;
  float cdf = 0.0f, t_last = 0.0f;
  for (int c = 0; c < n_seg; ++c) {
    const int l0 = c * st.seg;
    cdf = scan_rows<HAS_ENV>(st, f, single_sided, l0,
                             min(l0 + st.seg, st.n_live), cdf,
                             [&](int, float t, float) { t_last = t; });
    st.ck[c * st.stride] = cdf;
  }
  const float total = cdf;
  // the fallback row l_pad - 1 is a padding row (target 0) unless every
  // row holds a light
  if (st.n_live < l_pad) t_last = 0.0f;
  if (COUNT) evaluated = st.n_live;
  const RisDraws d = ris_draws(pu, looper, k, total);

  int idx[MAX_K];
  float tq[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    idx[j] = l_pad - 1;
    tq[j] = t_last;
  }
#pragma unroll 1
  for (int j = 0; j < k; ++j) {
    float thr = d.thr[0];
#pragma unroll
    for (int jj = 1; jj < MAX_K; ++jj)
      if (jj == j) thr = d.thr[jj];
    int lo = 0, hi = n_seg;  // first checkpoint above thr, n_seg if none
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st.ck[mid * st.stride] > thr)
        hi = mid;
      else
        lo = mid + 1;
    }
    if (lo == n_seg) continue;  // no row exceeds thr: the fallback row
    const int l0 = lo * st.seg;
    const int l1 = min(l0 + st.seg, st.n_live);
    int hit = -1;
    float tv = 0.0f;
    scan_rows<HAS_ENV>(st, f, single_sided, l0, l1,
                       lo ? st.ck[(lo - 1) * st.stride] : 0.0f,
                       [&](int l, float t, float run) {
                         if (hit < 0 && run > thr) {
                           hit = l;
                           tv = t;
                         }
                       });
    if (COUNT) evaluated += l1 - l0;
#pragma unroll
    for (int jj = 0; jj < MAX_K; ++jj) {
      if (jj == j && hit >= 0) {
        idx[jj] = hit;
        tq[jj] = tv;
      }
    }
  }
  return ris_finish<HAS_ENV>(lights, st.n_area, k, single_sided, has_met,
                             s, f, total, d, idx, tq);
}

// Blocks per SM: registers capped at 64 (80 with the env tiles, whose
// checkpoints leave room for 3 blocks). That spills 84-260 bytes of the
// RIS part to local memory but lets 32 (24) warps share an SM to hide
// the walk's load latency, where 93-96 registers allowed 16. b7_seg sizes
// the checkpoints for the same counts.
constexpr int kBlocksPerSm = 4, kBlocksPerSmEnv = 3;
constexpr int kSegs[] = {8, 16, 32};

// Shared memory per block: the area lights' psi rows (64 B), the env
// tiles' (d_tile, rad | lum) (20 B) and a cdf checkpoint every seg rows
// for each thread (ops/kernels/reuse.py, smem_bytes).
size_t b7_smem(int n_area, bool has_env, int seg) {
  const int n_env = has_env ? kEnvRows : 0;
  const int n_seg = (n_area + n_env + seg - 1) / seg;
  return (size_t)n_area * 64 + (size_t)n_env * 20 +
         (size_t)n_seg * PIX_BLOCK * sizeof(float);
}

// The checkpoint spacing: the smallest of kSegs whose shared memory lets
// the blocks per SM of the launch bounds share an SM of this device, else
// the largest.
cudaError_t b7_seg(int n_area, bool has_env, int* seg) {
  int dev, sm_smem, reserved;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  const size_t cap =
      (size_t)(sm_smem / (has_env ? kBlocksPerSmEnv : kBlocksPerSm)) -
      (size_t)reserved;
  *seg = kSegs[sizeof(kSegs) / sizeof(kSegs[0]) - 1];
  for (int s : kSegs) {
    if (b7_smem(n_area, has_env, s) <= cap) {
      *seg = s;
      break;
    }
  }
  return cudaSuccess;
}

template <bool COUNT, bool HAS_ENV>
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
  float4* area = smem4;
  float4* env = area + 4 * n_area;
  float* env_lum = reinterpret_cast<float*>(env + n_env);
  for (int i = threadIdx.x; i < 4 * n_area; i += blockDim.x)
    area[i] = psi_g[i];
  for (int i = threadIdx.x; i < n_env; i += blockDim.x) {
    const float4 a = psi_g[4 * (n_area + i)];
    const float4 c = psi_g[4 * (n_area + i) + 3];
    env[i] = make_float4(a.x, a.y, a.z, c.z);
    env_lum[i] = c.y;
  }
  __syncthreads();

  const int g = tile_pixel(width, pix0, r);
  if (g < 0) return;
  const int p = g - pix0;  // the band's pack column
  const LightStage st = {area,           env,
                         env_lum,        env_lum + n_env + threadIdx.x,
                         (int)blockDim.x, n_area,
                         n_area + n_env, seg};
  const Surface s = load_surface(gb, p, r);
  int evaluated = 0;
  const Candidate c = ris_select_seg<COUNT, HAS_ENV>(
      st, lights_g, l_pad, (uint32_t)g, looper, k, single_sided, has_met, s,
      evaluated);
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

template <bool COUNT, bool HAS_ENV>
int launch_reuse_bvh(const float* gb, uint32_t looper, const float* lights,
                     const float* psi, int l_pad, int n_area,
                     const BvhRows& bvh, float* rs, int* stats, int r,
                     int width, int pix0, int single_sided, int k,
                     int has_met, cudaStream_t stream) {
  int seg;
  cudaError_t e = b7_seg(n_area, HAS_ENV, &seg);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = b7_smem(n_area, HAS_ENV, seg);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(reuse_bvh_kernel<COUNT, HAS_ENV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  reuse_bvh_kernel<COUNT, HAS_ENV>
      <<<tile_grid(width, pix0, r), PIX_BLOCK, smem, stream>>>(
      gb, looper, lights, reinterpret_cast<const float4*>(psi), l_pad,
      n_area, seg, bvh, rs, stats, r, width, pix0, single_sided, k,
      has_met);
  return (int)cudaGetLastError();
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
// the pixel evaluated.
extern "C" int restir_reuse_bvh(const float* gb, uint32_t looper,
                                const float* lights, const float* psi,
                                int l_pad, int n_area, int has_env,
                                const float* rows, int size,
                                const float* planes, float* rs,
                                int* stats, int r, int width, int pix0,
                                int single_sided, int k, int has_met,
                                void* stream) {
  if (k < 1 || k > MAX_K || r <= 0 || size <= 0 || width <= 0 ||
      pix0 < 0 || n_area < 0 ||
      n_area + (has_env ? kEnvRows : 0) > l_pad)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream;
#define RESTIR_B7_LAUNCH(C, E)                                              \
  launch_reuse_bvh<C, E>(gb, looper, lights, psi, l_pad, n_area, bvh, rs, \
                         stats, r, width, pix0, single_sided, k, has_met, st)
  if (stats)
    return has_env ? RESTIR_B7_LAUNCH(true, true)
                   : RESTIR_B7_LAUNCH(true, false);
  return has_env ? RESTIR_B7_LAUNCH(false, true)
                 : RESTIR_B7_LAUNCH(false, false);
#undef RESTIR_B7_LAUNCH
}
