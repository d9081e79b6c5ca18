// Kernel B8: one ReSTIR GI path sample per pixel, the whole bounce loop
// in one launch.
//
// Replaces restir_tpu/ops/pallas/gi_kernel.py: _gi_trace_kernel
// (gi_trace_pallas). Per pixel, from the primary hit in the [IN_CH, R]
// pack, for depth 1..D: the shading normal turned toward wo (not on
// dielectrics), NEE from depth 2 (alias-table light pick, uniform point
// on the light triangle, any-hit shadow ray, MIS against the BSDF pdf),
// a BSDF sample (Lambert, GGX-VNDF metallic workflow, dielectric), the
// closest hit of the bounce ray, the hit's interpolated position, normal
// and uv and its material (procedural base colour when the material asks
// for it), and light hits with MIS (weight 1 at depth 1 and on delta
// samples). The first bounce records the sample point xs / ns, its pdf
// and delta flag; nv is the turned primary normal. Writes the
// [GO_CH, R] pack (Lo, nv, xs, ns, pdf, delta, 0, 0). The streams are
// pcg4d(pix0 + p, looper, CTR_PATH + 2 (d - 1) [+ 1], SALT_GI).
//
// Design. The TPU ran one kernel per bounce over a [34, R] state pack to
// bound its compile; here one thread carries one ray through every
// bounce and the path state lives in registers. Each bounce ray's
// closest hit and each NEE shadow ray are stackless MTBVH walks
// (bvh.cuh) over the scene's node rows with their boxes copied in
// (`BvhRows`: one dependent load per step), read through the read-only
// cache (the headline scene's rows and planes, ~185 KB, stay in L1 / L2);
// only the alias-table light rows (<= 32 KB) are staged in shared memory,
// once per block, so no barrier sits in the divergent loop. The
// walks' leaf test is gi_core.cuh's plane_hit, the arithmetic of the
// twin's brute-force intersect_bf, and they return its hit: padded
// boxes, the cull slack, ties to the lowest triangle, the shadow ray
// stopping at its first blocker. A lane whose path ends (no valid lobe,
// a miss, a light) stops working.
//
// Bound: the walks are chains of dependent loads on incoherent rays, not
// FLOPs (~590 box and ~27 plane tests per pixel on the headline scene),
// and a warp runs as long as its longest walk; the vertex work (BSDF,
// light and hash math, ~350 FLOP) comes next; bytes are 128 per pixel.
// More warps hide more of that latency: the launch bounds cap a thread at
// 64 registers (8 blocks of 128 per SM; ptxas spills 40-230 bytes to L1),
// 3 % faster than 80 registers and 6 resident blocks. The COUNT build
// writes each ray's box tests, plane tests and path vertices, from which
// chip_smoke.py counts the work these inputs take.
//
// Numerics: gi_core.cuh rounds as the plain twin (ops/kernels/gi.py
// gi_trace_ref) does on the card.
#include "bvh.cuh"
#include "gi_core.cuh"

using namespace restir;
using namespace restir::gi;

namespace {

constexpr int BLOCK = 128;

__device__ __forceinline__ V3 row3(const float* a) {
  return v3(a[0], a[1], a[2]);
}

// Any hit of the shadow segment x -> y (ops/intersect_bf.test_occlusion_bf:
// origin x + d 1e-5, blocked by a hit nearer than |y - x| - 2e-4).
template <bool COUNT>
__device__ __forceinline__ bool occluded(const BvhRows& bvh, V3 x, V3 y,
                                         WalkCount& n) {
  float limit;
  const GiRay ray = occlusion_ray(x, y, limit);
  return occluded_walk<COUNT>(bvh, ray, limit, -1, n);
}

template <bool COUNT, bool MET, bool DIE, bool PROC>
__global__ void __launch_bounds__(BLOCK, 8)
    gi_trace_kernel(const float* __restrict__ in, int r, uint32_t looper,
                    uint32_t pix0, BvhRows bvh, const float* __restrict__ tri,
                    const float* __restrict__ mats, int n_mat,
                    const float* __restrict__ lights, int n_lights,
                    float sum_inv, int depth, int single_sided,
                    float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ float sl[];  // [n_lights, 8] light rows
  for (int i = threadIdx.x; i < n_lights * LIGHT_COLS; i += blockDim.x)
    sl[i] = lights[i];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;

  auto I = [&](int c) { return in[(size_t)c * r + p]; };
  V3 pos = v3(I(IN_POS), I(IN_POS + 1), I(IN_POS + 2));
  V3 norm = v3(I(IN_NORM), I(IN_NORM + 1), I(IN_NORM + 2));
  V3 wo = neg(v3(I(IN_DIR), I(IN_DIR + 1), I(IN_DIR + 2)));
  // the pack has no base colour: the first bounce reads none
  Mat m = {I(IN_MTYPE), v3(0.0f, 0.0f, 0.0f), I(IN_METAL), I(IN_ROUGH),
           I(IN_IOR)};
  bool alive = I(IN_ALIVE) > 0.5f;

  V3 lo = v3(0.0f, 0.0f, 0.0f), thr = v3(1.0f, 1.0f, 1.0f);
  V3 nv = norm, xs = v3(0.0f, 0.0f, 0.0f), ns = xs;
  float prim_pdf = 1.0f, prim_delta = 0.0f;
  const uint32_t pix = pix0 + (uint32_t)p;
  WalkCount n = {0, 0};
  int verts = 0;

  for (int d = 1; d <= depth; ++d) {
    const bool first = d == 1;
    const bool delta_bsdf = m.type == 2.0f;
    if (!delta_bsdf && dot(norm, wo) < 0.0f) norm = neg(norm);
    if (first) nv = norm;
    if (!alive) break;
    ++verts;
    const uint32_t ctr = GI_CTR_PATH + 2u * (uint32_t)(d - 1);

    // NEE from depth 2 (restir.cu:290-300)
    if (!first && !delta_bsdf) {
      uint32_t hs[4];
      pcg4d(pix, looper, ctr, SALT_GI, hs);
      const float l1 = unit(hs[0]), l2 = unit(hs[1]), l3 = unit(hs[2]),
                  l4 = unit(hs[3]);
      const int pass = min((int)(l1 * (float)n_lights), n_lights - 1);
      const int id = l2 < sl[pass * LIGHT_COLS]
                         ? pass
                         : (int)sl[pass * LIGHT_COLS + 1];
      const float* lr = sl + id * LIGHT_COLS;
      const float* lt = tri + (size_t)(int)lr[2] * TRI_COLS;
      const V3 v0 = row3(lt), v1 = row3(lt + 3), v2 = row3(lt + 6);
      const float rr = sqrtf(l4);
      const float su = 1.0f - rr, sv = l3 * rr;
      const V3 sampled = weighted3(v1, su, v2, sv, v0, 1.0f - su - sv);
      const V3 lnormal = safe_normalize(cross(sub(v1, v0), sub(v2, v0)));
      const V3 to_s = sub(sampled, pos);
      const V3 rad = row3(lr + 3);
      const V3 wi = safe_normalize(to_s);
      const float dist = length(to_s);
      const float pdf_area = luminance(rad) * 2.0f * GI_PI * sum_inv;
      float pdf = pdf_area_to_solid_angle(pdf_area, pos, sampled, lnormal);
      if (single_sided && !(dot(lnormal, to_s) <= -1e-6f)) pdf = -1.0f;
      if (pdf > 0.0f &&
          occluded<COUNT>(bvh, pos,
                          add(scale(wi, clampmax(dist, 1e6f)), pos), n))
        pdf = -1.0f;
      if (pdf > 0.0f) {
        const V3 f = eval_bsdf<MET>(m, norm, wo, wi);
        const float bpdf = pdf_bsdf<MET>(m, norm, wo, wi);
        const float mis = power_heuristic(pdf, bpdf);
        const float s =
            clampmin(dot(norm, wi), 0.0f) * mis / clampmin(pdf, 1e-20f);
        lo = add(lo, scale(mul(mul(thr, f), rad), s));
      }
    }

    // BSDF bounce (restir.cu:302-325)
    uint32_t hb[4];
    pcg4d(pix, looper, ctr + 1u, SALT_GI, hb);
    const BsdfSample bs = sample_bsdf<MET, DIE>(m, norm, wo, unit(hb[0]),
                                                unit(hb[1]), unit(hb[2]));
    const bool ok = !(bs.flags & F_INVALID) && bs.pdf >= 1e-8f;
    const bool delta = (bs.flags & F_SPECULAR) != 0;
    if (first && ok) {
      prim_pdf = bs.pdf;
      prim_delta = delta ? 1.0f : 0.0f;
    }
    if (!ok) break;
    if (!first) {
      const float weight = delta ? 1.0f : fabsf(dot(norm, bs.wi));
      thr = scale(mul(thr, bs.f), weight / clampmin(bs.pdf, 1e-20f));
    }

    const V3 rd = bs.wi;
    const V3 ro = add(scale(rd, 1e-5f), pos);
    const GiRay ray = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z};
    int prim;
    float hu, hv;
    closest_walk<COUNT>(bvh, ray, prim, hu, hv, n);
    if (prim < 0) break;
    // the hit's interaction (ops/surface.make_interaction)
    const float* tr = tri + (size_t)prim * TRI_COLS;
    const float w0 = 1.0f - hu - hv;
    const V3 npos = weighted3(row3(tr + 3), hu, row3(tr + 6), hv,
                              row3(tr), w0);
    const V3 nn = safe_normalize(
        weighted3(row3(tr + TRI_NORM + 3), hu, row3(tr + TRI_NORM + 6), hv,
                  row3(tr + TRI_NORM), w0));
    const int mid = max((int)tr[TRI_MAT], 0);
    const float* mr = mats + (size_t)min(mid, n_mat - 1) * MAT_COLS;
    Mat nm = {mr[0], row3(mr + 1), mr[4], mr[5], mr[6]};
    if (PROC && mr[7] == -2.0f) {  // PROCEDURAL_TEXTURE
      const float* uv = tr + TRI_UV;
      const float pu = uv[2] * hu + uv[4] * hv + uv[0] * w0;
      const float pv = uv[3] * hu + uv[5] * hv + uv[1] * w0;
      const float c = procedural(pu, pv);
      nm.base = v3(c, c, c);
    }

    // light hit with MIS (restir.cu:345-367)
    const bool hit_light = nm.type == 4.0f;
    if (hit_light && (!single_sided || dot(nn, rd) < 0.0f)) {
      const float lpa = luminance(nm.base) * 2.0f * GI_PI * sum_inv;
      const float lpdf = pdf_area_to_solid_angle(lpa, pos, npos, nn);
      const float w =
          (delta || first) ? 1.0f : power_heuristic(bs.pdf, lpdf);
      lo = add(lo, scale(mul(nm.base, thr), w));
    }
    if (first) {
      xs = npos;
      ns = nn;
    }
    if (hit_light) break;
    pos = npos;
    norm = nn;
    wo = neg(rd);
    m = nm;
  }

  float* g = out + p;
  auto put = [&](int c, float v) { g[(size_t)c * r] = v; };
  put(GO_LO, lo.x);
  put(GO_LO + 1, lo.y);
  put(GO_LO + 2, lo.z);
  put(GO_NV, nv.x);
  put(GO_NV + 1, nv.y);
  put(GO_NV + 2, nv.z);
  put(GO_XS, xs.x);
  put(GO_XS + 1, xs.y);
  put(GO_XS + 2, xs.z);
  put(GO_NS, ns.x);
  put(GO_NS + 1, ns.y);
  put(GO_NS + 2, ns.z);
  put(GO_PDF, prim_pdf);
  put(GO_DELTA, prim_delta);
  put(GO_DELTA + 1, 0.0f);
  put(GO_DELTA + 2, 0.0f);
  if (COUNT) {
    counts[p] = n.boxes;
    counts[(size_t)r + p] = n.tris;
    counts[(size_t)2 * r + p] = verts;
  }
}

template <bool COUNT, bool MET, bool DIE, bool PROC>
int launch(const float* in, int r, uint32_t looper, uint32_t pix0,
           const BvhRows& bvh, const float* tri, const float* mats,
           int n_mat, const float* lights, int n_lights, float sum_inv,
           int depth, int single_sided, float* out, int* counts,
           cudaStream_t stream) {
  const size_t smem = (size_t)n_lights * LIGHT_COLS * 4;
  auto kern = gi_trace_kernel<COUNT, MET, DIE, PROC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(r + BLOCK - 1) / BLOCK, BLOCK, smem, stream>>>(
      in, r, looper, pix0, bvh, tri, mats, n_mat, lights, n_lights, sum_inv,
      depth, single_sided, out, counts);
  return (int)cudaGetLastError();
}

template <bool COUNT>
int launch_flags(const float* in, int r, uint32_t looper, uint32_t pix0,
                 const BvhRows& bvh, const float* tri, const float* mats,
                 int n_mat, const float* lights, int n_lights, float sum_inv,
                 int depth, int single_sided, int variant, float* out,
                 int* counts, cudaStream_t s) {
#define RESTIR_GI_TRACE(M, D, P)                                           \
  return launch<COUNT, M, D, P>(in, r, looper, pix0, bvh, tri, mats, n_mat, \
                                lights, n_lights, sum_inv, depth,          \
                                single_sided, out, counts, s)
  switch (variant) {
    case 0: RESTIR_GI_TRACE(false, false, false);
    case 1: RESTIR_GI_TRACE(false, false, true);
    case 2: RESTIR_GI_TRACE(false, true, false);
    case 3: RESTIR_GI_TRACE(false, true, true);
    case 4: RESTIR_GI_TRACE(true, false, false);
    case 5: RESTIR_GI_TRACE(true, false, true);
    case 6: RESTIR_GI_TRACE(true, true, false);
    default: RESTIR_GI_TRACE(true, true, true);
  }
#undef RESTIR_GI_TRACE
}

}  // namespace

// in: float32 [IN_CH, R]; rows [6B, 8] (node rows with their boxes),
// planes [n_pad, 12]: the scene's MTBVH (ops/kernels/tables.py);
// tri [n, 32];
// mats [n_mat, 16]; lights [n_lights, 8]. Writes out [GO_CH, R] and,
// unless null, counts [3, R] (box tests, plane tests, path vertices per
// ray).
extern "C" int restir_gi_trace(const float* in, int r, uint32_t looper,
                               uint32_t pix0, const float* rows, int size,
                               const float* planes, const float* tri,
                               const float* mats, int n_mat,
                               const float* lights, int n_lights,
                               float sum_inv, int depth, int single_sided,
                               int has_met, int has_die, int has_proc,
                               float* out, int* counts, void* stream) {
  if (r <= 0 || size <= 0 || n_mat <= 0 || n_lights <= 0 || depth <= 0)
    return (int)cudaErrorInvalidValue;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const int variant = (has_met ? 4 : 0) | (has_die ? 2 : 0) |
                      (has_proc ? 1 : 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (counts != nullptr)
    return launch_flags<true>(in, r, looper, pix0, bvh, tri, mats, n_mat,
                              lights, n_lights, sum_inv, depth, single_sided,
                              variant, out, counts, s);
  return launch_flags<false>(in, r, looper, pix0, bvh, tri, mats, n_mat,
                             lights, n_lights, sum_inv, depth, single_sided,
                             variant, out, counts, s);
}
