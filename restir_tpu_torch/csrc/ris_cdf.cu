// Kernel B10: the general path's ReSTIR DI candidate stage. K draws from
// the per-pixel CDF over all area lights, a single-draw winner, and the
// winner's shadow ray through the scene's MTBVH.
//
// Replaces restir_tpu/ops/pallas/ris_kernel.py::_ris_kernel
// (ris_cdf_pallas). The TPU kernel builds the [L, B] target matrix and its
// CDF with bf16-split matmuls, then tests the winner's ray against every
// triangle; here two launches: B7's light search
// (ris_search.cuh's ris_search_kernel without env rows: B1's RIS core
// with the same per-light target, sequential CDF, K candidates and
// winner pick, bit for bit) on a Surface built from the [14, R] input
// pack (pos, normal, wo, material type / metallic / roughness, shade,
// primitive) writes each pixel's candidate to the output pack, then
// ris_cdf_kernel, one pixel a thread, walks the stackless MTBVH
// (bvh.cuh's occluded_walk on BvhRows) with the TPU kernel's contract:
// origin pushed 1e-5 along wi, a hit counts at 0 < t < dist (1 - 1e-3) -
// 1e-4 on a triangle other than the pixel's own (shadow_ray,
// shadow_limit: B7's ray). The leaf test is
// plane_hit, the twin's, so the walk returns the every-row loop's
// occlusion. The RNG is pcg4d on the global pixel index pix0 + p (pix0:
// the first pixel of a row band, 0 for the whole frame), counters
// CTR_RIS + j, salt SALT_RESTIR; the packs are read and written at p.
//
// The search reads the psi rows through a double buffer of kChunkRows
// rows in shared memory (common.cuh, stream_rows), several pixels a
// thread, keeps a cdf checkpoint every S rows for each pixel beside it
// (b7_seg's spacing, B7's) and re-scans one segment a candidate from
// device memory, so any light count fits a block: n_l + K * S light
// targets a pixel. The first designs staged both [l_pad, 16] tables in
// shared memory (more than 1,792 rows did not fit) and scanned them
// twice, 2 l_pad targets. Its targets and frame (ris_frame,
// light_target4: the FMA fusion spelled out), draws, candidates and
// winner are B7's and round as ris_select's do: a copy of ris_select's
// plain expressions, inlined into streamed loops, fused the total's adds
// otherwise and moved 2 % of the weights by an ulp.
//
// Bound: FMA throughput of the light targets (~32 FLOP each) and the K
// candidates (~120 FLOP each), then the latency of the shadow walk's
// dependent loads, as B7; the walk reads node and plane rows from global
// memory through the read-only cache. Lanes whose winner carries no
// weight do not walk. The COUNT build also returns each walk's box and
// plane tests.
#include "bvh.cuh"
#include "ris_search.cuh"
#if defined(PROBE_WALK)
#include "prof/walk_probe.cuh"  // stage probes (restir_tpu_torch/prof)
#endif

using namespace restir;

namespace {

constexpr int BLOCK = 256;

// input / output pack channels (ris_kernel.py:37-41)
enum {
  I_POS = 0, I_NORM = 3, I_WO = 6, I_MTYPE = 9, I_METAL = 10, I_ROUGH = 11,
  I_SHADE = 12, I_PRIM = 13
};
enum { O_LI = 0, O_WI = 3, O_DIST = 6, O_W = 7, O_M = 8, O_PAD = 9 };

// The search reads a pixel's Surface from the input pack and writes its
// candidate (the weight before visibility), M and the pad channel to the
// output pack.
struct CdfIo {
  const float* __restrict__ in;
  float* __restrict__ out;
  int r, k;
  __device__ __forceinline__ Surface surface(int p) const {
    const float* g = in + p;
    auto at = [&](int ch) { return g[(size_t)ch * r]; };
    Surface s;
    s.px = at(I_POS);
    s.py = at(I_POS + 1);
    s.pz = at(I_POS + 2);
    s.nx = at(I_NORM);
    s.ny = at(I_NORM + 1);
    s.nz = at(I_NORM + 2);
    s.dx = -at(I_WO);  // the Surface carries the ray direction, -wo
    s.dy = -at(I_WO + 1);
    s.dz = -at(I_WO + 2);
    s.mtype = at(I_MTYPE);
    s.metallic = at(I_METAL);
    s.roughness = at(I_ROUGH);
    s.shade = at(I_SHADE) > 0.5f;
    s.prim = __float2int_rz(at(I_PRIM));
    return s;
  }
  __device__ __forceinline__ void put(int p, const Surface& s,
                                      const Candidate& c, int) const {
    float* o = out + p;
    auto set = [&](int ch, float val) { o[(size_t)ch * r] = val; };
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      set(O_LI + i, c.li[i]);
      set(O_WI + i, c.wi[i]);
    }
    set(O_DIST, c.dist);
    set(O_W, c.r_weight);
    set(O_M, s.shade ? (float)k : 0.0f);
    set(O_PAD, 0.0f);
  }
};

// The walk: the shadow ray of the winner the search wrote to out, from
// the input pack's shading point; an occluded winner's weight becomes 0.
// Lanes whose winner carries no weight do not walk.
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    ris_cdf_kernel(const float* __restrict__ in, BvhRows bvh,
                   float* __restrict__ out, int* __restrict__ stats, int r) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= r) return;
  Surface s = {};
  s.px = in[(size_t)I_POS * r + p];
  s.py = in[(size_t)(I_POS + 1) * r + p];
  s.pz = in[(size_t)(I_POS + 2) * r + p];
  s.prim = __float2int_rz(in[(size_t)I_PRIM * r + p]);
  Candidate c = {};
#pragma unroll
  for (int i = 0; i < 3; ++i) c.wi[i] = out[(size_t)(O_WI + i) * r + p];
  c.dist = out[(size_t)O_DIST * r + p];
  c.r_weight = out[(size_t)O_W * r + p];
  WalkCount n = {0, 0};
#if defined(PROBE_WALK)
  if (PROBE_WALK == 2) n = {stats[p], stats[(size_t)r + p]};
  const bool blocked =
      c.r_weight > 0.0f &&
      probe_occluded_walk<PROBE_WALK>(bvh, shadow_ray(s, c),
                                      shadow_limit(c), s.prim, n);
#else
  const bool blocked =
      c.r_weight > 0.0f && occluded_walk<COUNT>(bvh, shadow_ray(s, c),
                                                shadow_limit(c), s.prim, n);
#endif
  if (blocked) out[(size_t)O_W * r + p] = 0.0f;
  if (COUNT) {
    stats[p] = n.boxes;
    stats[(size_t)r + p] = n.tris;
  }
}

template <bool COUNT>
int launch_ris_cdf(const float* in, uint32_t looper, uint32_t pix0,
                   const float* lights, const float* psi, int l_pad,
                   int n_area, int parts, const BvhRows& bvh, float* out,
                   int* stats, int r, int single_sided, int k, int has_met,
                   cudaStream_t stream) {
  int seg;
  cudaError_t e = b7_seg(n_area, false, &seg);
  if (e != cudaSuccess) return (int)e;
  if (parts & 1) {
    e = launch_ris_search<false, false>(CdfIo{in, out, r, k}, lights, psi,
                                        l_pad, n_area, seg, pix0, looper, r,
                                        single_sided, k, has_met, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (parts & 2) {
    ris_cdf_kernel<COUNT><<<(r + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        in, bvh, out, stats, r);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// in: float32 [14, R]; lights / psi: [l_pad, 16] (tables.light_tables;
// psi 16-byte aligned); rows [6B, 8] (node rows with their boxes),
// planes [n_pad, 12]: the scene's MTBVH (ops/kernels/tables.py). Writes
// out [10, R]: li (3), wi (3), dist, weight (zero when the winner is
// occluded), M, 0. stats: null, or int32 [2, R] that receives each
// shadow walk's box and plane test counts. pix0: the global index of
// pixel 0 of the pack, the key of its draws. parts: 1 the search (out
// before visibility), 2 the walk (on the out the search wrote), 3 both.
extern "C" int restir_ris_cdf(const float* in, uint32_t looper,
                              uint32_t pix0, const float* lights,
                              const float* psi, int l_pad, int n_area,
                              int parts, const float* rows, int size,
                              const float* planes, float* out,
                              int* stats, int r, int single_sided, int k,
                              int has_met, void* stream_) {
  if (k < 1 || k > MAX_K || r <= 0 || l_pad <= 0 || size <= 0 ||
      n_area < 0 || n_area > l_pad || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(psi) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const BvhRows bvh = {reinterpret_cast<const float4*>(rows), planes, size};
  const cudaStream_t st = (cudaStream_t)stream_;
  return stats ? launch_ris_cdf<true>(in, looper, pix0, lights, psi, l_pad,
                                      n_area, parts, bvh, out, stats, r,
                                      single_sided, k, has_met, st)
               : launch_ris_cdf<false>(in, looper, pix0, lights, psi, l_pad,
                                       n_area, parts, bvh, out, stats, r,
                                       single_sided, k, has_met, st);
}
