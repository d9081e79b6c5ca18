// Device math of the ReSTIR GI kernels B8 (gi_trace.cu) and B9
// (gi_resolve.cu).
//
// Each function mirrors, operation for operation, the PyTorch code that
// the kernels' plain twins run on the card (ops/bsdf.py, utils/math.py,
// ops/lights.py, ops/surface.py, ops/texture.py, ops/intersect_bf.py):
// the same products and sums in the same order, IEEE division and
// square root. The GI sources build with -fmad=false (ops/kernels/
// _build.py), so no product is contracted into an FMA behind the code's
// back; the only FMAs are the explicit fmaf of the plane dots, where the
// twin's float32 matrix product accumulates in that order. So B8 and B9
// round as their twins do on the card and the two agree lane for lane,
// while the math is that of the JAX package's Pallas kernels
// (restir_tpu/ops/pallas/gi_kernel.py:156-324, its XLA tracer
// models/restir_gi.py:142-282 and ops/bsdf.py).
//
// Nothing here is inlined by the DI kernels (B1 and B2 stay
// bit-identical); B8's MTBVH walks are bvh.cuh's, on GiRay's leaf test,
// and so are those of the general path's B11 and B12 (intersect.cu, also
// built with -fmad=false), which share occlusion_ray with B8.
#pragma once

#include "common.cuh"

namespace restir {
namespace gi {

// ---- pack channels (gi_kernel.py:68-138) ----
enum {
  IN_POS = 0, IN_NORM = 3, IN_DIR = 6, IN_MTYPE = 9, IN_METAL = 10,
  IN_ROUGH = 11, IN_IOR = 12, IN_ALIVE = 13, IN_CH = 16
};
enum {
  GO_LO = 0, GO_NV = 3, GO_XS = 6, GO_NS = 9, GO_PDF = 12, GO_DELTA = 13,
  GO_CH = 16
};
enum {
  Q_LO = 0, Q_XV = 3, Q_NV = 6, Q_XS = 9, Q_NS = 12, Q_W = 15, Q_M = 16,
  Q_PRIM = 17, Q_GNORM = 18, Q_DEPTH = 21, Q_CH = 24
};
enum {
  GQ_MOTION = 0, GQ_PRIM = 1, GQ_DEPTH = 2, GQ_NORM = 3, GQ_ALB = 6,
  GQ_SHADE = 9, GQ_CH = 10
};
// RNG counters and salt of the GI pass (restir_gi.py:46-48)
enum { GI_CTR_UPDATE = 0, GI_CTR_TEMPORAL = 1, GI_CTR_PATH = 2, SALT_GI = 0x04 };
// table columns (ops/kernels/tables.py: gi_tri, mat, gi_lights); a mat
// row is type, base colour (3), metallic, roughness, ior, base map id, ...
enum { TRI_COLS = 32, TRI_NORM = 9, TRI_UV = 18, TRI_MAT = 24 };
enum { MAT_COLS = 16, LIGHT_COLS = 8 };
// BSDF sample-type flags (ops/bsdf.py)
enum {
  F_DIFFUSE = 1, F_GLOSSY = 2, F_SPECULAR = 4, F_REFLECTION = 16,
  F_TRANSMISSION = 32, F_INVALID = 1 << 15
};

// float32 roundings of utils/math.py's double constants
#define GI_PI 3.14159274f         // float32(PI)
#define GI_TWO_PI 6.28318548f     // float32(2 PI)
#define GI_INV_PI 0.318309873f    // float32(1 / PI)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return {x, y, z};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// torch.clamp(x, min=lo) / max=hi: NaN stays NaN
__device__ __forceinline__ float clampmin(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clampmax(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// utils/math.py: dot sums left to right; length, safe_normalize, cross,
// weighted3 (x wx + y wy + z wz), luminance, power_heuristic
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float length(V3 v) { return sqrtf(dot(v, v)); }
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float l = clampmin(length(v), 1e-20f);
  return {v.x / l, v.y / l, v.z / l};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 weighted3(V3 x, float wx, V3 y, float wy, V3 z,
                                        float wz) {
  return {x.x * wx + y.x * wy + z.x * wz, x.y * wx + y.y * wy + z.y * wz,
          x.z * wx + y.z * wy + z.z * wz};
}
__device__ __forceinline__ float luminance(V3 c) {
  return c.x * 0.2126f + c.y * 0.7152f + c.z * 0.0722f;
}
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float f2 = f * f;
  return f2 / (g * g + f2);
}

// Area pdf at y (normal ny) seen from x, as a solid-angle pdf.
__device__ __forceinline__ float pdf_area_to_solid_angle(float pdf, V3 x, V3 y,
                                                         V3 ny) {
  const V3 yx = sub(x, y);
  const float d2 = dot(yx, yx);
  return pdf * d2 / clampmin(fabsf(dot(ny, safe_normalize(yx))), 1e-20f);
}

// (t, b) about n: helper (0, 0, 1) when |n.y| > 0.9999, else (0, 1, 0);
// b = normalize(n x helper), t = b x n.
__device__ __forceinline__ void local_ref_frame(V3 n, V3& t, V3& b) {
  const V3 helper =
      fabsf(n.y) > 0.9999f ? v3(0.0f, 0.0f, 1.0f) : v3(0.0f, 1.0f, 0.0f);
  b = safe_normalize(cross(n, helper));
  t = cross(b, n);
}

__device__ __forceinline__ void concentric_disk(float x, float y, float& dx,
                                                float& dy) {
  const float r = sqrtf(x);
  const float theta = y * GI_TWO_PI;
  dx = cosf(theta) * r;
  dy = sinf(theta) * r;
}

__device__ __forceinline__ V3 sample_hemisphere_cosine(V3 n, float rx,
                                                       float ry) {
  float dx, dy;
  concentric_disk(rx, ry, dx, dy);
  const float z = sqrtf(clampmin(1.0f - (dx * dx + dy * dy), 0.0f));
  V3 t, b;
  local_ref_frame(n, t, b);
  return safe_normalize(weighted3(t, dx, b, dy, n, z));
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ float schlick_g(float c, float alpha) {
  const float a = alpha * 0.5f;
  return c / clampmin(c * (1.0f - a) + a, 1e-20f);
}

__device__ __forceinline__ float gtr2_distrib(float c, float alpha) {
  const float aa = alpha * alpha;
  float denom = c * c * (aa - 1.0f) + 1.0f;
  denom = denom * denom * GI_PI;
  return c < 1e-6f ? 0.0f : aa / clampmin(denom, 1e-20f);
}

struct Mat {
  float type;  // 0 Lambert, 1 metallic workflow, 2 dielectric, 4 light
  V3 base;
  float metallic, roughness, ior;
};

// ops/bsdf._metallic_eval: mix(diffuse, spec, fresnel) where
// cos_i cos_o >= 1e-7, else 0.
__device__ __forceinline__ V3 metallic_eval(const Mat& m, V3 n, V3 wo, V3 wi) {
  const float alpha = m.roughness * m.roughness;
  const V3 h = safe_normalize(add(wo, wi));
  const float cos_o = dot(n, wo);
  const float cos_i = dot(n, wi);
  if (!(cos_i * cos_o >= 1e-7f)) return v3(0.0f, 0.0f, 0.0f);
  const float t = pow5(1.0f - dot(h, wo));
  const float g =
      schlick_g(fabsf(cos_o), alpha) * schlick_g(fabsf(cos_i), alpha);
  const float d = gtr2_distrib(dot(n, h), alpha);
  const float spec = g * d / clampmin(4.0f * cos_i * cos_o, 1e-20f);
  const float b[3] = {m.base.x, m.base.y, m.base.z};
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = 0.08f * (1.0f - m.metallic) + b[c] * m.metallic;
    const float fr = f0 * (1.0f - t) + t;
    const float diffuse = b[c] * GI_INV_PI * (1.0f - m.metallic);
    out[c] = diffuse * (1.0f - fr) + spec * fr;
  }
  return v3(out[0], out[1], out[2]);
}

// ops/bsdf._metallic_pdf
__device__ __forceinline__ float metallic_pdf(const Mat& m, V3 n, V3 wo,
                                              V3 wi) {
  const float alpha = m.roughness * m.roughness;
  const V3 h = safe_normalize(add(wo, wi));
  const float gtr2_pdf = gtr2_distrib(dot(n, h), alpha) *
                         schlick_g(dot(n, wo), alpha) * fabsf(dot(h, wo)) /
                         clampmin(fabsf(dot(n, wo)), 1e-20f);
  const float spec_pdf = gtr2_pdf / clampmin(4.0f * fabsf(dot(h, wo)), 1e-20f);
  const float diff_pdf = clampmin(dot(n, wi), 0.0f) * GI_INV_PI;
  const float t = 1.0f / (2.0f - m.metallic);
  return diff_pdf * (1.0f - t) + spec_pdf * t;
}

// f(wo, wi): Lambert, metallic workflow; delta lobes and others 0.
template <bool MET>
__device__ __forceinline__ V3 eval_bsdf(const Mat& m, V3 n, V3 wo, V3 wi) {
  if (m.type == 0.0f) return scale(m.base, GI_INV_PI);
  if (MET && m.type == 1.0f) return metallic_eval(m, n, wo, wi);
  return v3(0.0f, 0.0f, 0.0f);
}

template <bool MET>
__device__ __forceinline__ float pdf_bsdf(const Mat& m, V3 n, V3 wo, V3 wi) {
  if (m.type == 0.0f) return clampmin(dot(n, wi), 0.0f) * GI_INV_PI;
  if (MET && m.type == 1.0f) return metallic_pdf(m, n, wo, wi);
  return 0.0f;
}

// Heitz's VNDF GGX half-vector sample (ops/bsdf.gtr2_sample_vndf).
__device__ __forceinline__ V3 gtr2_sample_vndf(V3 n, V3 wo, float alpha,
                                               float rx, float ry) {
  V3 t, b;
  local_ref_frame(n, t, b);
  const float lx = dot(wo, t), ly = dot(wo, b), lz = dot(wo, n);
  const V3 vh = safe_normalize(v3(lx * alpha, ly * alpha, lz));
  const float len_sq = vh.x * vh.x + vh.y * vh.y;
  V3 t1 = v3(1.0f, 0.0f, 0.0f);
  if (len_sq > 0.0f) {
    const float sl = sqrtf(clampmin(len_sq, 1e-20f));
    t1 = v3(-vh.y / sl, vh.x / sl, 0.0f / sl);
  }
  const V3 t2 = cross(vh, t1);
  float px, p1;
  concentric_disk(rx, ry, px, p1);
  const float s = 0.5f * (vh.z + 1.0f);
  const float one_m_px2 = -px * px + 1.0f;
  const float py = (1.0f - s) * sqrtf(clampmin(one_m_px2, 0.0f)) + s * p1;
  const float pz = sqrtf(clampmin(-py * py + one_m_px2, 0.0f));
  V3 h = weighted3(t1, px, t2, py, vh, pz);
  h = v3(h.x * alpha, h.y * alpha, clampmin(h.z, 0.0f));
  return safe_normalize(weighted3(t, h.x, b, h.y, n, h.z));
}

// Exact dielectric Fresnel (ops/bsdf.fresnel_dielectric).
__device__ __forceinline__ float fresnel_dielectric(float cos_in, float ior) {
  ior = cos_in < 0.0f ? 1.0f / ior : ior;
  cos_in = fabsf(cos_in);
  const float sin_in = sqrtf(clampmin(-cos_in * cos_in + 1.0f, 0.0f));
  const float sin_tr = sin_in / ior;
  const float cos_tr = sqrtf(clampmin(-sin_tr * sin_tr + 1.0f, 0.0f));
  float rs = (-ior * cos_tr + cos_in) / clampmin(ior * cos_tr + cos_in, 1e-20f);
  float rp = (ior * cos_in + -cos_tr) / clampmin(ior * cos_in + cos_tr, 1e-20f);
  rs = rs * rs;
  rp = rp * rp;
  return sin_tr >= 1.0f ? 1.0f : (rs + rp) * 0.5f;
}

// Snell refraction of wi about n (utils/math.refract) -> ok.
__device__ __forceinline__ bool refract(V3 n, V3 wi, float ior, V3& wt) {
  const float cos_in = dot(n, wi);
  ior = cos_in < 0.0f ? 1.0f / ior : ior;
  const float sin2_in = clampmin(-cos_in * cos_in + 1.0f, 0.0f);
  const float sin2_tr = sin2_in / (ior * ior);
  float cos_tr = sqrtf(clampmin(1.0f - sin2_tr, 0.0f));
  cos_tr = cos_in < 0.0f ? -cos_tr : cos_tr;
  const float k = cos_in / ior - cos_tr;
  wt = safe_normalize(v3(n.x * k + -wi.x / ior, n.y * k + -wi.y / ior,
                         n.z * k + -wi.z / ior));
  return sin2_tr < 1.0f;
}

struct BsdfSample {
  V3 wi, f;
  float pdf;
  int flags;
};

// Material::sample (ops/bsdf.sample_bsdf) for the lane's own lobe; a type
// the build leaves out (MET / DIE false) or no BSDF samples INVALID.
template <bool MET, bool DIE>
__device__ __forceinline__ BsdfSample sample_bsdf(const Mat& m, V3 n, V3 wo,
                                                  float rx, float ry,
                                                  float rz) {
  BsdfSample s;
  if (m.type == 0.0f) {
    s.wi = sample_hemisphere_cosine(n, rx, ry);
    s.f = scale(m.base, GI_INV_PI);
    s.pdf = clampmin(dot(n, s.wi), 0.0f) * GI_INV_PI;
    s.flags = F_DIFFUSE | F_REFLECTION;
    return s;
  }
  if (MET && m.type == 1.0f) {
    const float alpha = m.roughness * m.roughness;
    const V3 h = gtr2_sample_vndf(n, wo, alpha, rx, ry);
    const float k = 2.0f * dot(wo, h);
    const V3 refl = safe_normalize(v3(wo.x * -1.0f + h.x * k,
                                      wo.y * -1.0f + h.y * k,
                                      wo.z * -1.0f + h.z * k));
    const bool pick_diffuse = rz > 1.0f / (2.0f - m.metallic);
    s.wi = pick_diffuse ? sample_hemisphere_cosine(n, rx, ry) : refl;
    s.f = metallic_eval(m, n, wo, s.wi);
    s.pdf = metallic_pdf(m, n, wo, s.wi);
    s.flags = dot(n, s.wi) < 0.0f ? F_INVALID : (F_GLOSSY | F_REFLECTION);
    return s;
  }
  if (DIE && m.type == 2.0f) {
    const float cos_wo = dot(n, wo);
    const float pdf_refl = fresnel_dielectric(cos_wo, m.ior);
    const bool choose_refl = rz < pdf_refl;
    if (choose_refl) {
      const float k = 2.0f * cos_wo;
      s.wi = safe_normalize(v3(n.x * k + -wo.x, n.y * k + -wo.y,
                               n.z * k + -wo.z));
      s.f = m.base;
      s.flags = F_SPECULAR | F_REFLECTION;
    } else {
      const bool ok = refract(n, wo, m.ior, s.wi);
      const float eta = cos_wo < 0.0f ? 1.0f / m.ior : m.ior;
      const float e2 = eta * eta;
      s.f = v3(m.base.x / e2, m.base.y / e2, m.base.z / e2);
      s.flags = ok ? (F_SPECULAR | F_TRANSMISSION) : F_INVALID;
    }
    s.pdf = 1.0f;
    return s;
  }
  s.wi = v3(0.0f, 0.0f, 1.0f);
  s.f = v3(0.0f, 0.0f, 0.0f);
  s.pdf = 1.0f;
  s.flags = F_INVALID;
  return s;
}

// The sine-grid procedural base colour (ops/texture.procedural_texture):
// the cell index wraps as uint32, the float -> int casts truncate and
// saturate.
__device__ __forceinline__ float procedural(float u, float v) {
  const uint32_t cell = (uint32_t)__float2int_rz(u * 1024.0f) * 1024u +
                        (uint32_t)__float2int_rz(v * 1024.0f);
  uint32_t hsh[4];
  pcg4d(cell, 0u, 0u, 0x7Fu, hsh);
  const float rx = unit(hsh[0]), ry = unit(hsh[1]);
  const float f = (sinf(u * 10.0f * GI_TWO_PI + rx * GI_TWO_PI) + 1.0f) * 0.5f;
  const float g = (sinf(v * 10.0f * GI_TWO_PI + ry * GI_TWO_PI) + 1.0f) * 0.5f;
  return f * g;
}

// Ray against a unit-triangle plane row q (xu 0:4, xv 4:8, xw 8:12) as
// ops/intersect_bf._chunk_hits computes it on the card: the plane dots
// accumulate as the float32 product [o, 1] @ xform does (one FMA per
// term, in index order), u and v round the product and the sum apart.
// Returns t, or -1 without a hit.
__device__ __forceinline__ float plane_hit(const float* q, V3 o, V3 d, float& u,
                                           float& v) {
  const float oou = fmaf(q[2], o.z, fmaf(q[1], o.y, q[0] * o.x)) + q[3];
  const float oov = fmaf(q[6], o.z, fmaf(q[5], o.y, q[4] * o.x)) + q[7];
  const float oow = fmaf(q[10], o.z, fmaf(q[9], o.y, q[8] * o.x)) + q[11];
  const float ddu = fmaf(q[2], d.z, fmaf(q[1], d.y, q[0] * d.x));
  const float ddv = fmaf(q[6], d.z, fmaf(q[5], d.y, q[4] * d.x));
  const float ddw = fmaf(q[10], d.z, fmaf(q[9], d.y, q[8] * d.x));
  const bool nondeg = fabsf(ddw) >= 1e-12f;
  const float t = -oow / (nondeg ? ddw : 1.0f);
  u = t * ddu + oou;
  v = t * ddv + oov;
  const bool hit =
      nondeg && t > 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  return hit ? t : -1.0f;
}

// A ray with the GI plane_hit as the MTBVH walks' leaf test (bvh.cuh).
struct GiRay {
  float ox, oy, oz, dx, dy, dz;
  __device__ __forceinline__ float hit(const float* q, float& u,
                                       float& v) const {
    return plane_hit(q, v3(ox, oy, oz), v3(dx, dy, dz), u, v);
  }
};

// The shadow ray of the segment x -> y as ops/intersect_bf.occlusion_ray
// computes it on the card: direction (y - x) / max(|y - x|, 1e-20), origin
// x + d 1e-5, and in `limit` the distance a blocker must be nearer than,
// |y - x| - 2e-4.
__device__ __forceinline__ GiRay occlusion_ray(V3 x, V3 y, float& limit) {
  const V3 seg = sub(y, x);
  const float dist = sqrtf(dot(seg, seg));
  const float den = clampmin(dist, 1e-20f);
  const V3 d = v3(seg.x / den, seg.y / den, seg.z / den);
  const V3 o = add(scale(d, 1e-5f), x);
  limit = dist - 2e-4f;
  return {o.x, o.y, o.z, d.x, d.y, d.z};
}

}  // namespace gi
}  // namespace restir
