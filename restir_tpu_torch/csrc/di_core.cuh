// Device code shared by the fused DI kernels: raygen, the unit-plane hit
// test, the G-buffer epilogue (with its texture and env branches), the
// K-candidate CDF RIS core (with its env-tile candidates) and the winner
// shadow ray's origin and limit.
//
// B1 (fused_di.cu, resident scenes), B6 (gbuffer_bvh.cu, MTBVH closest
// hit) and B7 (reuse_bvh.cu, RIS + MTBVH any hit) all call these, with
// the same MTBVH walks (bvh.cuh), so a frame rendered through B6 + B7 +
// B1b runs the same arithmetic as one rendered through B1. Mirrors restir_tpu/ops/pallas/fused_di.py
// (_raygen, _gbuffer_epilogue, _tex_bilinear, _procedural_tex,
// _env_tile_radiance, _ris_select_core, _vis_resident_core).
//
// The env and texture branches sit behind the compile-time flags HAS_ENV
// and TEX; with both off the code is the env-less build's. Their float
// arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), so every operation rounds where the plain PyTorch twin's
// does and each kernel that inlines them rounds the same way.
#pragma once

#include "common.cuh"

namespace restir {

constexpr int MAX_K = 8;

// RIS target weight of light row `ps` at a shading point (identical math
// to fused_di._ris_select_core's three psi products). B7 evaluates the
// same target through reuse_bvh.cu's light_target4 / env_target, whose
// intrinsics spell out the FMAs nvcc fuses here, so both pick alike. The
// B1 == B6 + B7 + B1b checks guard the pair: in tests/test_torch_cuda.py
// test_b6_b7_env_tex_match_b1 and
// test_mtbvh_path_matches_b1_on_resident_scene, and chip_smoke.py
// phases 4 and 8 at 1080p. Run them after an edit on either side.
__device__ __forceinline__ float light_target(const float* ps, float nx,
                                              float ny, float nz, float ndx,
                                              float px, float py, float pz,
                                              float x2, int single_sided) {
  const float a = ps[0] * nx + ps[1] * ny + ps[2] * nz + ps[3] * (-ndx);
  const float bb = ps[4] * px + ps[5] * py + ps[6] * pz + ps[7];
  float d2 = ps[8] * (-2.0f * px) + ps[9] * (-2.0f * py) +
             ps[10] * (-2.0f * pz) + ps[11] + ps[12] * x2;
  d2 = fmaxf(d2, 1e-8f);
  const bool side = single_sided ? bb > 0.0f : fabsf(bb) > 0.0f;
  const float rad = ps[14];
  const bool above = (a + rad) > 0.0f;
  const float a_eff = fmaxf(a, 0.1f * rad);
  return (above && side) ? ps[13] * a_eff * fabsf(bb) / (d2 * d2) : 0.0f;
}

// Ray vs unit-triangle plane row q (xu 0:4, xv 4:8, xw 8:12): returns the
// hit distance (or -1) and the barycentrics.
__device__ __forceinline__ float plane_hit(const float* q, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& u, float& v) {
  const float oou = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
  const float oov = q[4] * ox + q[5] * oy + q[6] * oz + q[7];
  const float oow = q[8] * ox + q[9] * oy + q[10] * oz + q[11];
  const float ddu = q[0] * dx + q[1] * dy + q[2] * dz;
  const float ddv = q[4] * dx + q[5] * dy + q[6] * dz;
  const float ddw = q[8] * dx + q[9] * dy + q[10] * dz;
  const bool nondeg = fabsf(ddw) >= 1e-12f;
  const float t = -oow / (nondeg ? ddw : 1.0f);
  u = oou + t * ddu;
  v = oov + t * ddv;
  const bool hit =
      nondeg && t > 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  return hit ? t : -1.0f;
}

// A ray with plane_hit as the MTBVH walks' leaf test (bvh.cuh).
struct PlaneRay {
  float ox, oy, oz, dx, dy, dz;
  __device__ __forceinline__ float hit(const float* q, float& u,
                                       float& v) const {
    return plane_hit(q, ox, oy, oz, dx, dy, dz, u, v);
  }
};

// The same ray and test, with the plane row (48 B, 16-byte aligned) read
// as three float4 loads through the read-only path, where nvcc emits 12
// scalar loads for PlaneRay. The same hit bit for bit; it pays in B6's
// and B7's walks, while B1's env build ran slower with it (PERF.md §6),
// so each kernel names its leaf loads by the ray type it walks.
struct PlaneRay4 : PlaneRay {
  __device__ __forceinline__ float hit(const float* q, float& u,
                                       float& v) const {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4 a = __ldg(q4), b = __ldg(q4 + 1), c = __ldg(q4 + 2);
    const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
    return plane_hit(row, ox, oy, oz, dx, dy, dz, u, v);
  }
};

// ---- env map and textures (HAS_ENV / TEX branches) ----

// One op, rounded on its own (never contracted into an FMA).
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

#define RESTIR_ENV_DIST 1.0e8f  // shadow limit of an env winner (ENV_DIST)
#define RESTIR_ENV_TH 16        // env tile grid (scene_data.ENV_TILE_H/W)
#define RESTIR_ENV_TW 32

// float32 roundings of cos(pi * t / 16), t = 1..15, and of the
// pseudo-angle of 2 pi s / 32, s = 1..31 (fused_di._pseudo_angle_const),
// both computed in double: the tile thresholds of _env_tile_radiance.
__constant__ float kEnvCosY[RESTIR_ENV_TH - 1] = {
    0.980785251f, 0.923879504f, 0.831469595f, 0.707106769f, 0.555570245f,
    0.382683426f, 0.195090324f, 6.12323426e-17f, -0.195090324f,
    -0.382683426f, -0.555570245f, -0.707106769f, -0.831469595f,
    -0.923879504f, -0.980785251f};
__constant__ float kEnvAngX[RESTIR_ENV_TW - 1] = {
    0.165910676f, 0.292893231f, 0.400543809f, 0.5f, 0.599456191f,
    0.707106769f, 0.834089339f, 1.0f, 1.16591072f, 1.29289317f,
    1.40054381f, 1.5f, 1.59945619f, 1.70710683f, 1.83408928f, 2.0f,
    2.16591072f, 2.29289317f, 2.40054393f, 2.5f, 2.59945607f, 2.70710683f,
    2.83408928f, 3.0f, 3.16591072f, 3.29289317f, 3.40054393f, 3.5f,
    3.59945607f, 3.70710683f, 3.83408928f};

struct EnvTex {
  const float4* env_rad;   // [512] tile radiance (r, g, b, 0)
  const float4* atlas;     // [rows * 128] texels (r, g, b, 0)
  const float4* tex_meta;  // [T] (row0, width, height, valid)
  int n_tex;
};

// Piecewise-constant env radiance along a direction: the elevation tile
// from 15 cosine compares on dy, the azimuth tile from 31 pseudo-angle
// compares on (dx, dz), no trigonometry (_env_tile_radiance).
__device__ __forceinline__ float4 env_tile_radiance(const float4* env_rad,
                                                   float dx, float dy,
                                                   float dz) {
  int ty = 0;
#pragma unroll
  for (int t = 0; t < RESTIR_ENV_TH - 1; ++t) ty += dy <= kEnvCosY[t];
  float p = __fdiv_rn(dz, fadd(fadd(fabsf(dx), fabsf(dz)), 1e-20f));
  p = dx < 0.0f ? fsub(2.0f, p) : (dz < 0.0f ? fadd(4.0f, p) : p);
  int tx = 0;
#pragma unroll
  for (int s = 0; s < RESTIR_ENV_TW - 1; ++s) tx += p >= kEnvAngX[s];
  return __ldg(env_rad + ty * RESTIR_ENV_TW + tx);
}

// a - floor(a / m) * m, with a result of m (a float edge) folded to 0.
__device__ __forceinline__ float tex_wrap(float a, float m) {
  const float w = fsub(a, fmul(floorf(__fdiv_rn(a, m)), m));
  return w >= m ? 0.0f : w;
}

// Wrap-mode bilinear fetch of texture `tid` at (u, v) from the
// mip-clamped atlas (_tex_bilinear; image.h:41-74).
__device__ __forceinline__ void tex_bilinear(const EnvTex& et, int tid,
                                             float u_uv, float v_uv,
                                             float out[3]) {
  const float4 meta = __ldg(et.tex_meta + (tid < et.n_tex ? tid : 0));
  const float row0 = tid < et.n_tex ? meta.x : 0.0f;
  const float tw = fmaxf(tid < et.n_tex ? meta.y : 0.0f, 1.0f);
  const float th = fmaxf(tid < et.n_tex ? meta.z : 0.0f, 1.0f);
  const float u = fsub(u_uv, floorf(u_uv));
  const float v = fsub(v_uv, floorf(v_uv));
  const float fx = fsub(fmul(u, tw), 0.5f);
  const float fy = fsub(fmul(v, th), 0.5f);
  const float ix = floorf(fx), iy = floorf(fy);
  const float lx = fsub(fx, ix), ly = fsub(fy, iy);
  const float x0 = tex_wrap(ix, tw), y0 = tex_wrap(iy, th);
  const float x1 = tex_wrap(fadd(x0, 1.0f), tw);
  const float y1 = tex_wrap(fadd(y0, 1.0f), th);
  const float4* r0 = et.atlas + (size_t)__float2int_rz(fadd(row0, y0)) * 128;
  const float4* r1 = et.atlas + (size_t)__float2int_rz(fadd(row0, y1)) * 128;
  const int ix0 = __float2int_rz(x0), ix1 = __float2int_rz(x1);
  const float4 c00 = __ldg(r0 + ix0), c10 = __ldg(r0 + ix1);
  const float4 c01 = __ldg(r1 + ix0), c11 = __ldg(r1 + ix1);
  const float a00[3] = {c00.x, c00.y, c00.z}, a10[3] = {c10.x, c10.y, c10.z};
  const float a01[3] = {c01.x, c01.y, c01.z}, a11[3] = {c11.x, c11.y, c11.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float cx0 = fadd(a00[c], fmul(fsub(a10[c], a00[c]), lx));
    const float cx1 = fadd(a01[c], fmul(fsub(a11[c], a01[c]), lx));
    out[c] = fadd(cx0, fmul(fsub(cx1, cx0), ly));
  }
}

// Sine-grid procedural texture with its pcg4d jitter (_procedural_tex;
// scene.h:68-76). The cell index wraps as uint32; the float -> int casts
// truncate and saturate as XLA's do.
__device__ __forceinline__ float procedural_tex(float u_uv, float v_uv) {
  const uint32_t cell =
      (uint32_t)__float2int_rz(fmul(u_uv, 1024.0f)) * 1024u +
      (uint32_t)__float2int_rz(fmul(v_uv, 1024.0f));
  uint32_t h[4];
  pcg4d(cell, 0u, 0u, 0x7Fu, h);
  const float two_pi = 6.28318548f;  // float32(2 * 3.14159265358979)
  const float rx = unit(h[0]), ry = unit(h[1]);
  const float f = fmul(
      fadd(sinf(fadd(fmul(fmul(u_uv, 10.0f), two_pi), fmul(rx, two_pi))),
           1.0f),
      0.5f);
  const float g = fmul(
      fadd(sinf(fadd(fmul(fmul(v_uv, 10.0f), two_pi), fmul(ry, two_pi))),
           1.0f),
      0.5f);
  return fmul(f, g);
}

// 1 / max(|(x, y, z)|, 1e-20) in the twin's rounding order.
__device__ __forceinline__ float inv_len(float x, float y, float z) {
  return __fdiv_rn(
      1.0f,
      fmaxf(__fsqrt_rn(fadd(fadd(fmul(x, x), fmul(y, y)), fmul(z, z))),
            1e-20f));
}

// Tangent-space normal-map texel -> world normal around n
// (local_to_world(n, normalize(texel - 0.5)), _gbuffer_epilogue).
__device__ __forceinline__ void normal_map(const float t[3], float& nx,
                                           float& ny, float& nz) {
  float vx = fsub(t[0], 0.5f), vy = fsub(t[1], 0.5f), vz = fsub(t[2], 0.5f);
  const float vinv = inv_len(vx, vy, vz);
  vx = fmul(vx, vinv);
  vy = fmul(vy, vinv);
  vz = fmul(vz, vinv);
  const bool usez = fabsf(ny) > 0.9999f;
  float bx = usez ? ny : -nz, by = usez ? -nx : 0.0f, bz = usez ? 0.0f : nx;
  const float binv = inv_len(bx, by, bz);
  bx = fmul(bx, binv);
  by = fmul(by, binv);
  bz = fmul(bz, binv);
  const float tx = fsub(fmul(by, nz), fmul(bz, ny));
  const float ty = fsub(fmul(bz, nx), fmul(bx, nz));
  const float tz = fsub(fmul(bx, ny), fmul(by, nx));
  const float rx = fadd(fadd(fmul(tx, vx), fmul(bx, vy)), fmul(nx, vz));
  const float ry = fadd(fadd(fmul(ty, vx), fmul(by, vy)), fmul(ny, vz));
  const float rz = fadd(fadd(fmul(tz, vx), fmul(bz, vy)), fmul(nz, vz));
  const float rinv = inv_len(rx, ry, rz);
  nx = fmul(rx, rinv);
  ny = fmul(ry, rinv);
  nz = fmul(rz, rinv);
}

// The interpolated texture coordinate of a hit (a + u b + v c).
__device__ __forceinline__ float bary(float a, float b, float c, float u,
                                      float v) {
  return fadd(fadd(a, fmul(u, b)), fmul(v, c));
}

struct Ray {
  float x, y;  // raster coordinates of the pixel
  float ox, oy, oz, dx, dy, dz;
};

// Camera::sample with AA jitter for linear pixel p.
__device__ __forceinline__ Ray raygen(const float* cam, int p, uint32_t looper,
                                      int width, int height, float aspect,
                                      int aa_jitter) {
  Ray ray;
  ray.x = (float)(p % width);
  ray.y = (float)(p / width);
  float rx = 0.5f, ry = 0.5f;
  if (aa_jitter) {
    uint32_t h[4];
    pcg4d((uint32_t)p, looper, 0u, SALT_CAMERA, h);
    rx = unit(h[0]);
    ry = unit(h[1]);
  }
  const float inv_w = (float)(1.0 / (double)width);
  const float inv_h = (float)(1.0 / (double)height);
  const float tanf_ = cam[12], focal = cam[13];
  const float ruv_x = 1.0f - 2.0f * (ray.x + rx) * inv_w;
  const float ruv_y = 1.0f - 2.0f * (ray.y + ry) * inv_h;
  const float fx = ruv_x * (aspect * tanf_ * focal);
  const float fy = ruv_y * (tanf_ * focal);
  // right * fx + up * fy + view * focal, with the FMA contraction spelled
  // out: left to the compiler, it fused different products of these sums
  // depending on the code around them, which moved the direction by an
  // ulp between builds. This is the contraction of the original B1 build.
  float dx =
      __fmaf_rn(cam[9], focal, __fmaf_rn(cam[6], fy, __fmul_rn(cam[3], fx)));
  float dy =
      __fmaf_rn(cam[10], focal, __fmaf_rn(cam[4], fx, __fmul_rn(cam[7], fy)));
  float dz =
      __fmaf_rn(cam[11], focal, __fmaf_rn(cam[5], fx, __fmul_rn(cam[8], fy)));
  const float dinv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  ray.dx = dx * dinv;
  ray.dy = dy * dinv;
  ray.dz = dz * dinv;
  ray.ox = cam[0];
  ray.oy = cam[1];
  ray.oz = cam[2];
  return ray;
}

// What the RIS core and the shadow ray read of a pixel: exactly the gb
// pack's values, so B7 rebuilding it from gb matches B1's registers.
struct Surface {
  float px, py, pz;  // G_POS
  float nx, ny, nz;  // G_NORM
  float dx, dy, dz;  // G_DIR
  float mtype, metallic, roughness;
  bool shade;
  int prim;  // G_PRIM as int (-1 when not valid)
};

// G-buffer epilogue (fused_di._gbuffer_epilogue): interpolate the hit
// (best, bprim, bu, bv; best == RESTIR_BIG on a miss), reproject it
// through the last camera, write the pixel's gb column and return what
// the RIS core reads.
// With TEX, the material's base, metallic, roughness and normal maps
// (and the procedural base colour) are read at the hit's uv; with HAS_ENV a
// miss carries the env radiance along the ray in the albedo slot.
template <bool HAS_ENV, bool TEX>
__device__ __forceinline__ Surface gbuffer_epilogue(
    float* __restrict__ gb, int p, int r, const Ray& ray, float best,
    int bprim, float bu, float bv, const float* __restrict__ attr,
    const float* __restrict__ mat, int n_mat, const float* __restrict__ lcam,
    int width, int height, float aspect, int single_sided, const EnvTex& et) {
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const bool valid0 = best < RESTIR_BIG;
  const float* at = attr + (valid0 ? bprim : 0) * 32;
  auto A = [&](int j) { return valid0 ? at[j] : 0.0f; };
  const float pxp = A(0) + bu * A(3) + bv * A(6);
  const float pyp = A(1) + bu * A(4) + bv * A(7);
  const float pzp = A(2) + bu * A(5) + bv * A(8);
  float nxp = A(9) + bu * A(12) + bv * A(15);
  float nyp = A(10) + bu * A(13) + bv * A(16);
  float nzp = A(11) + bu * A(14) + bv * A(17);
  const float nlen =
      1.0f / sqrtf(fmaxf(nxp * nxp + nyp * nyp + nzp * nzp, 1e-20f));
  nxp *= nlen;
  nyp *= nlen;
  nzp *= nlen;
  const float mat_id_f = A(24);
  const int mat_id = __float2int_rz(mat_id_f);
  const bool mat_ok = mat_id >= 0 && mat_id < n_mat;
  const float* mr = mat + (mat_ok ? mat_id : 0) * 16;
  auto M = [&](int j) { return mat_ok ? mr[j] : 0.0f; };

  // metallic / roughness / normal maps, before the front-face test reads
  // the normal (a per-pixel form of the TPU kernel's per-tile lax.cond)
  float u_uv = 0.0f, v_uv = 0.0f, met_map = 0.0f, rough_map = 0.0f;
  if constexpr (TEX) {
    u_uv = bary(A(18), A(20), A(22), bu, bv);
    v_uv = bary(A(19), A(21), A(23), bu, bv);
    const float met_id = M(8), rough_id = M(9), nrm_id = M(10);
    float t[3];
    if (valid0 && met_id > -0.5f) {
      tex_bilinear(et, __float2int_rz(met_id), u_uv, v_uv, t);
      met_map = t[0];
    }
    if (valid0 && rough_id > -0.5f) {
      tex_bilinear(et, __float2int_rz(rough_id), u_uv, v_uv, t);
      rough_map = t[0];
    }
    if (valid0 && nrm_id > -0.5f) {
      tex_bilinear(et, __float2int_rz(nrm_id), u_uv, v_uv, t);
      normal_map(t, nxp, nyp, nzp);
    }
  }

  const float mtype = M(0);
  bool is_light = valid0 && mtype == 4.0f;
  const bool front = (nxp * dx + nyp * dy + nzp * dz) < 0.0f;
  const bool valid = single_sided ? valid0 && !(is_light && !front) : valid0;
  is_light = is_light && valid;
  const bool shade = valid && !is_light;
  const float prim_remap = valid ? (is_light ? -2.0f : mat_id_f) : -1.0f;

  const float px = valid ? pxp : 0.0f;
  const float py = valid ? pyp : 0.0f;
  const float pz = valid ? pzp : 0.0f;
  const float tox = px - ox, toy = py - oy, toz = pz - oz;
  const float depth =
      valid ? sqrtf(tox * tox + toy * toy + toz * toz) : 1.0f;

  // motion: reproject through the last camera (Camera::getRasterUV)
  float lx = px - lcam[0], ly = py - lcam[1], lz = pz - lcam[2];
  const float linv = 1.0f / sqrtf(fmaxf(lx * lx + ly * ly + lz * lz, 1e-20f));
  lx *= linv;
  ly *= linv;
  lz *= linv;
  const float ldep = lx * lcam[9] + ly * lcam[10] + lz * lcam[11];
  const float ldep_inv = 1.0f / (fabsf(ldep) < 1e-20f ? 1e-20f : ldep);
  const float prx = (lx * lcam[3] + ly * lcam[4] + lz * lcam[5]) * ldep_inv;
  const float pry = (lx * lcam[6] + ly * lcam[7] + lz * lcam[8]) * ldep_inv;
  const float ltan = lcam[12];
  const float un = (-(prx / (aspect * ltan))) * 0.5f + 0.5f;
  const float vn = (-(pry / ltan)) * 0.5f + 0.5f;
  const int mx = __float2int_rz(un * (float)width);
  const int my = __float2int_rz(vn * (float)height);
  const bool in_b = mx >= 0 && mx < width && my >= 0 && my < height;
  const float motion =
      valid ? (in_b ? (float)(my * width + mx) : -1.0f) : 0.0f;

  const float gnx = valid ? nxp : 0.0f;
  const float gny = valid ? nyp : 0.0f;
  const float gnz = valid ? nzp : 0.0f;
  float metallic = M(4), roughness = M(5);
  float alb[3] = {valid ? M(1) : 0.0f, valid ? M(2) : 0.0f,
                  valid ? M(3) : 0.0f};
  if constexpr (TEX) {
    if (valid0 && M(8) > -0.5f) metallic = met_map;
    if (valid0 && M(9) > -0.5f) roughness = rough_map;
    const float tid = M(7);  // base map: -1 none, -2 procedural
    if (valid && tid > -0.5f) {
      tex_bilinear(et, __float2int_rz(tid), u_uv, v_uv, alb);
    } else if (valid && tid > -2.5f && tid < -1.5f) {
      alb[0] = alb[1] = alb[2] = procedural_tex(u_uv, v_uv);
    }
  }
  if constexpr (HAS_ENV) {
    if (!valid) {
      const float4 e = env_tile_radiance(et.env_rad, dx, dy, dz);
      alb[0] = e.x;
      alb[1] = e.y;
      alb[2] = e.z;
    }
  }
  const float prim_f = valid ? (float)bprim : -1.0f;
  float* g = gb + p;
  g[(size_t)(G_POS + 0) * r] = px;
  g[(size_t)(G_POS + 1) * r] = py;
  g[(size_t)(G_POS + 2) * r] = pz;
  g[(size_t)(G_NORM + 0) * r] = gnx;
  g[(size_t)(G_NORM + 1) * r] = gny;
  g[(size_t)(G_NORM + 2) * r] = gnz;
  g[(size_t)(G_DIR + 0) * r] = dx;
  g[(size_t)(G_DIR + 1) * r] = dy;
  g[(size_t)(G_DIR + 2) * r] = dz;
  g[(size_t)(G_ALB + 0) * r] = alb[0];
  g[(size_t)(G_ALB + 1) * r] = alb[1];
  g[(size_t)(G_ALB + 2) * r] = alb[2];
  g[(size_t)G_DEPTH * r] = depth;
  g[(size_t)G_MOTION * r] = motion;
  g[(size_t)G_PRIMR * r] = prim_remap;
  g[(size_t)G_MTYPE * r] = mtype;
  g[(size_t)G_METAL * r] = metallic;
  g[(size_t)G_ROUGH * r] = roughness;
  g[(size_t)G_SHADE * r] = shade ? 1.0f : 0.0f;
  g[(size_t)G_LIGHT * r] = is_light ? 1.0f : 0.0f;
  g[(size_t)G_MISS * r] = valid ? 0.0f : 1.0f;
  g[(size_t)G_PRIM * r] = prim_f;
  g[(size_t)G_X * r] = ray.x;
  g[(size_t)G_Y * r] = ray.y;

  Surface s;
  s.px = px;
  s.py = py;
  s.pz = pz;
  s.nx = gnx;
  s.ny = gny;
  s.nz = gnz;
  s.dx = dx;
  s.dy = dy;
  s.dz = dz;
  s.mtype = mtype;
  s.metallic = metallic;
  s.roughness = roughness;
  s.shade = shade;
  s.prim = valid ? bprim : -1;
  return s;
}

// The Surface of pixel p, read back from a gb pack.
__device__ __forceinline__ Surface load_surface(const float* __restrict__ gb,
                                                int p, int r) {
  const float* g = gb + p;
  Surface s;
  s.px = g[(size_t)(G_POS + 0) * r];
  s.py = g[(size_t)(G_POS + 1) * r];
  s.pz = g[(size_t)(G_POS + 2) * r];
  s.nx = g[(size_t)(G_NORM + 0) * r];
  s.ny = g[(size_t)(G_NORM + 1) * r];
  s.nz = g[(size_t)(G_NORM + 2) * r];
  s.dx = g[(size_t)(G_DIR + 0) * r];
  s.dy = g[(size_t)(G_DIR + 1) * r];
  s.dz = g[(size_t)(G_DIR + 2) * r];
  s.mtype = g[(size_t)G_MTYPE * r];
  s.metallic = g[(size_t)G_METAL * r];
  s.roughness = g[(size_t)G_ROUGH * r];
  s.shade = g[(size_t)G_SHADE * r] > 0.5f;
  s.prim = __float2int_rz(g[(size_t)G_PRIM * r]);
  return s;
}

// B7's (and B10's) form of light_target, with the FMA
// fusion spelled out (reuse_bvh.cu's note). The frame the light targets
// read: the normal facing wo (dielectrics
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

struct Candidate {
  float li[3], wi[3], dist, r_weight;
};

// K-candidate CDF RIS over the per-pixel light CDF with a single-draw
// winner (fused_di._ris_select_core). psi / lights are the [l_pad, 16]
// tables (shared memory in the kernels). B7 searches the cdf instead of
// scanning it twice, and evaluates its candidates and winner with its
// own copy of the code below (ris_finish, further down): taking a shared
// winner function here, in two forms, moved B1's texture build by an ulp
// on some lanes (PERF.md §6), so the copies stay apart, and the
// B1 == B6 + B7 + B1b tests named at light_target keep them equal.
// Lanes without a winner get
// li = wi = 0, dist = 0. With HAS_ENV, rows from n_area on are env tiles:
// a pick there samples a uv-uniform direction in the tile with its exact
// solid-angle pdf, and its shadow ray runs to RESTIR_ENV_DIST.
template <bool HAS_ENV>
__device__ __forceinline__ Candidate ris_select(
    const float* psi, const float* lights, int l_pad, int n_area,
    uint32_t pu, uint32_t looper, int k, int single_sided, int has_met,
    const Surface& s) {
  const float px = s.px, py = s.py, pz = s.pz;
  const float mtype = s.mtype;
  const float wox = -s.dx, woy = -s.dy, woz = -s.dz;
  float nx = s.nx, ny = s.ny, nz = s.nz;
  if (mtype != 2.0f && (nx * wox + ny * woy + nz * woz) < 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  const float ndx = nx * px + ny * py + nz * pz;
  const float x2 = px * px + py * py + pz * pz;

  float total = 0.0f;
  for (int l = 0; l < l_pad; ++l)
    total += light_target(psi + l * 16, nx, ny, nz, ndx, px, py, pz, x2,
                          single_sided);

  float r2[MAX_K], r3[MAX_K], thr[MAX_K], tq[MAX_K], r4_0 = 0.0f;
  int idx[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    r2[j] = r3[j] = thr[j] = tq[j] = 0.0f;
    idx[j] = -1;
    if (j < k) {
      uint32_t h[4];
      pcg4d(pu, looper, (uint32_t)(CTR_RIS + j), SALT_RESTIR, h);
      thr[j] = unit(h[0]) * total;
      r2[j] = unit(h[1]);
      r3[j] = unit(h[2]);
      if (j == 0) r4_0 = unit(h[3]);
    }
  }
  // idx_j = min(#(cdf <= thr_j), l_pad - 1): the cdf is non-decreasing,
  // so that is the first row whose cdf exceeds thr_j
  float cdf = 0.0f, t_last = 0.0f;
  for (int l = 0; l < l_pad; ++l) {
    const float t = light_target(psi + l * 16, nx, ny, nz, ndx, px, py, pz,
                                 x2, single_sided);
    cdf += t;
    t_last = t;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      if (j < k && idx[j] < 0 && cdf > thr[j]) {
        idx[j] = l;
        tq[j] = t;
      }
    }
  }

  float w[MAX_K], cli[MAX_K][3], cwi[MAX_K][3], cdist[MAX_K];
  const float total_safe = fmaxf(total, 1e-20f);
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    w[j] = 0.0f;
    cli[j][0] = cli[j][1] = cli[j][2] = 0.0f;
    cwi[j][0] = cwi[j][1] = cwi[j][2] = 0.0f;
    cdist[j] = 0.0f;
    if (j >= k) continue;
    if (idx[j] < 0) {
      idx[j] = l_pad - 1;
      tq[j] = t_last;
    }
    const float* L = lights + idx[j] * 16;
    const float q = tq[j] / total_safe;
    float wix, wiy, wiz, pdf, dist;
    if (HAS_ENV && idx[j] >= n_area) {
      // env tile (u0, v0 | du | dv): uv-uniform point, to_sphere
      const float u_s = fadd(L[0], fmul(r2[j], L[3]));
      const float v_s = fadd(L[1], fmul(r3[j], L[6]));
      const float phi = fmul(u_s, 6.28318548f);  // float32(2 pi)
      const float th = fmul(v_s, 3.14159274f);
      const float st = sinf(th);
      wix = fmul(cosf(phi), st);
      wiy = cosf(th);
      wiz = fmul(sinf(phi), st);
      pdf = __fdiv_rn(q, fmaxf(fmul(fmul(fmul(L[3], L[6]), 19.7392082f),
                                    fmaxf(st, 1e-6f)),
                               1e-20f));
      pdf = (total > 0.0f && q > 0.0f) ? pdf : -1.0f;
      dist = RESTIR_ENV_DIST;
    } else {
      const float sr = sqrtf(fmaxf(r3[j], 0.0f));
      const float b_u = 1.0f - sr;
      const float b_v = r2[j] * sr;
      const float sx = L[0] + b_u * L[3] + b_v * L[6];
      const float sy = L[1] + b_u * L[4] + b_v * L[7];
      const float sz = L[2] + b_u * L[5] + b_v * L[8];
      const float tx = sx - px, ty = sy - py, tz = sz - pz;
      const float dist2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f);
      const float inv_dist = 1.0f / sqrtf(dist2);
      wix = tx * inv_dist;
      wiy = ty * inv_dist;
      wiz = tz * inv_dist;
      const float cos_l = L[9] * wix + L[10] * wiy + L[11] * wiz;
      pdf = q * dist2 / fmaxf(L[15] * fabsf(cos_l), 1e-20f);
      if (single_sided) pdf = cos_l <= -1e-6f ? pdf : -1.0f;
      pdf = (total > 0.0f && q > 0.0f) ? pdf : -1.0f;
      dist = dist2 * inv_dist;
    }
    const float f_lum = bsdf_lum(mtype, s.metallic, s.roughness, nx, ny, nz,
                                 wox, woy, woz, wix, wiy, wiz, has_met);
    const float li_lum = 0.2126f * L[12] + 0.7152f * L[13] + 0.0722f * L[14];
    const float cos_s = fmaxf(nx * wix + ny * wiy + nz * wiz, 0.0f);
    const float wj = li_lum * f_lum * cos_s / pdf;
    const bool bad = isnan(wj) || isinf(wj) || pdf <= 0.0f;
    w[j] = (bad || !s.shade) ? 0.0f : wj;
    cli[j][0] = L[12];
    cli[j][1] = L[13];
    cli[j][2] = L[14];
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
  const float thresh = r4_0 * c;
  int jsel = 0;
#pragma unroll
  for (int j = 0; j < MAX_K - 1; ++j)
    if (j < k - 1 && cums[j] <= thresh) ++jsel;
  const bool gate = c > 0.0f && s.shade;
  out.li[0] = out.li[1] = out.li[2] = 0.0f;
  out.wi[0] = out.wi[1] = out.wi[2] = 0.0f;
  out.dist = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (gate && j == jsel) {
      out.li[0] = cli[j][0];
      out.li[1] = cli[j][1];
      out.li[2] = cli[j][2];
      out.wi[0] = cwi[j][0];
      out.wi[1] = cwi[j][1];
      out.wi[2] = cwi[j][2];
      out.dist = cdist[j];
    }
  }
  return out;
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
// single-draw winner, as in ris_select (B7 and B10).
// lights: the [l_pad, 16] rows in global memory, read through the
// read-only path. Lanes without a winner
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

// The winner's shadow ray (fused_di._vis_resident_core): origin pushed
// 1e-5 along wi, and a hit counts only at 0 < t < limit on a triangle
// other than the pixel's own.
__device__ __forceinline__ float shadow_limit(const Candidate& c) {
  return c.dist * 0.999f - 1e-4f;
}

// That ray from surface s towards its winner c (B1a, B7, B10).
__device__ __forceinline__ PlaneRay shadow_ray(const Surface& s,
                                               const Candidate& c) {
  return {s.px + c.wi[0] * 1e-5f, s.py + c.wi[1] * 1e-5f,
          s.pz + c.wi[2] * 1e-5f, c.wi[0], c.wi[1], c.wi[2]};
}

// Write the rs pack column of pixel p (weight zeroed when occluded).
__device__ __forceinline__ void write_rs(float* __restrict__ rs, int p, int r,
                                        const Candidate& c, bool occluded) {
  float* o = rs + p;
  o[(size_t)(RS_LI + 0) * r] = c.li[0];
  o[(size_t)(RS_LI + 1) * r] = c.li[1];
  o[(size_t)(RS_LI + 2) * r] = c.li[2];
  o[(size_t)(RS_WI + 0) * r] = c.wi[0];
  o[(size_t)(RS_WI + 1) * r] = c.wi[1];
  o[(size_t)(RS_WI + 2) * r] = c.wi[2];
  o[(size_t)RS_DIST * r] = c.dist;
  o[(size_t)RS_W * r] = occluded ? 0.0f : c.r_weight;
}

}  // namespace restir
