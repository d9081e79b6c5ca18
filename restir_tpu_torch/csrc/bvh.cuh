// Stackless MTBVH walks over global memory (the CUDA original's
// scene.h:245-316; the tables of restir_tpu/scene/bvh.py).
//
// One thread walks one ray. Table t = get_mtbvh_id(-d) orders every
// node's children near-to-far for the ray's dominant axis; a node whose
// padded box the ray misses (or enters beyond the current limit) jumps to
// its `miss` index, past its subtree, so the walk is one loop with no
// stack. Leaves run the ray's own unit-plane test on the triangle's plane
// row: `RayT::hit` is di_core.cuh's plane_hit for the DI kernels (B1, B6,
// B7, B10; `PlaneRay`, or `PlaneRay4` with float4 row loads in B6, B7) and
// gi_core.cuh's for B8, B11 and B12 (`gi::GiRay`), each the test
// of the brute-force loop that kernel's twin runs.
//
// Exactness against a brute-force loop over every row: node boxes are
// padded outward at upload (ops/kernels/tables.py), a box is entered
// while its entry distance is at most CULL_SLACK times the current best
// (or shadow limit), and equal distances keep the lowest primitive id. So
// the walk visits every triangle that could win and returns the brute
// force's hit.
//
// Bound: the walk is a chain of dependent loads through the read-only
// cache, not FMAs; a warp waits out the latency of its longest walk. Each
// node row carries its box (`BvhRows`: one 32-byte row per step), so the
// chain is one load deep: no second load waits on the node row for the
// box it points at (the JAX tables' box_id indirection). Kernels whose
// rays are one per pixel (B6, B7, and B13's primary and any hit when the
// caller passes the batch's geometry) launch 8x4-pixel warps (common.cuh,
// tile_pixel), so a warp's walks share their nodes' cache lines; B13's
// closest hit walks its rays sorted by their loop and origin (sort.cu,
// the ray key); the rest launch one ray per thread in ray order.
// Refilling a warp's idle lanes from a ray queue does not pay on these
// walks (intersect.cu).
//
// The COUNT variants also return the boxes and triangles tested, for
// the measurement of the walk's work (tests and chip_smoke.py); the
// builds without counters carry no counting code.
//
// B14's walk (heat_walk) and B13's closest hit (octant_closest_walk)
// pick each box's near and far planes once per ray from the signs of its
// inverse direction (octant_slab): 4 min / max per box test where `slab`
// takes 10, with the same differences, products and comparisons, so
// every descend decision is the same.
#pragma once

#include "common.cuh"

namespace restir {

// 1 + 2^-13: entry distances within this factor of the best hit are
// still entered.
#define RESTIR_CULL_SLACK 1.0001220703125f

// A visited node: its padded (or, for the exact walks, its own) box and
// its (prim, miss) pair.
struct BvhNode {
  float4 lo, hi;
  int prim, miss;
};

// The MTBVH as every walk reads it: table t's node j at row t * B + j,
// one 32-byte row (padded box lo, prim bits) (padded box hi, miss bits).
// The exact walks read rows with unpadded boxes and vertex rows in place
// of the plane rows.
struct BvhRows {
  const float4* rows;    // [6B, 2]
  const float* planes;   // [n_pad, 12] unit-plane rows (or vertex rows)
  int size;              // B
  __device__ __forceinline__ BvhNode node(int row) const {
    const float4 lo = __ldg(rows + 2 * row), hi = __ldg(rows + 2 * row + 1);
    return {lo, hi, __float_as_int(lo.w), __float_as_int(hi.w)};
  }
};

// Table index for direction (dx, dy, dz) (scene.h:101-119); callers pass
// the negated ray direction, as scene.h:250 does.
__device__ __forceinline__ int mtbvh_id(float dx, float dy, float dz) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  if (ax > ay && ax > az) return dx > 0.0f ? 0 : 1;
  if (ay >= ax && ay > az) return dy > 0.0f ? 2 : 3;
  return dz > 0.0f ? 4 : 5;
}

// 1 / d with |d| clamped to 1e-12 (ops/intersect.py::intersect_aabb), so
// (lo - o) * inv is never 0 * inf.
__device__ __forceinline__ float safe_inv(float d) {
  const float ds = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / ds;
}

// A ray with a NaN origin or direction component. The twins' slab test
// (torch.minimum / maximum, as the JAX package's jnp.minimum) keeps a
// NaN, so such a ray misses every box, the root's first; `slab`'s fminf /
// fmaxf would drop the NaN axis and walk on the other two. The exact
// walks (B13, B14) test this once, before their loop: such a ray tests
// the root's box and goes to its miss index, which is the table's end
// (scene/bvh.py), as the twin does. The loop itself is unchanged.
template <class RayT>
__device__ __forceinline__ bool nan_ray(const RayT& ray) {
  return isnan(ray.ox) || isnan(ray.oy) || isnan(ray.oz) || isnan(ray.dx) ||
         isnan(ray.dy) || isnan(ray.dz);
}

// Slab test; t_near may be negative when the origin is inside the box.
__device__ __forceinline__ bool slab(float4 lo, float4 hi, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float& t_near) {
  const float tx1 = (lo.x - ox) * ix, tx2 = (hi.x - ox) * ix;
  const float ty1 = (lo.y - oy) * iy, ty2 = (hi.y - oy) * iy;
  const float tz1 = (lo.z - oz) * iz, tz2 = (hi.z - oz) * iz;
  t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_far =
      fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return t_far >= 0.0f && t_far >= t_near;
}

// `slab` for a ray whose inverse direction has the sign bits OCT (bit 0:
// ix < 0, bit 1: iy, bit 2: iz): per axis the near plane is the box's lo
// where the inverse is positive and its hi where it is negative. For a
// box with lo <= hi (ops/kernels/tables.py refuses any other exact row)
// and an axis whose origin is finite and whose inverse is not zero, the
// rounding of (lo - o) * i and (hi - o) * i keeps their order, or
// reverses it with i, so tn / tf are the values slab's fminf / fmaxf
// pick (a zero's sign aside, which no comparison sees), and a NaN axis
// is NaN in both. The walk keeps `slab` for the other rays.
template <int OCT>
__device__ __forceinline__ bool octant_slab(float4 lo, float4 hi, float ox,
                                            float oy, float oz, float ix,
                                            float iy, float iz,
                                            float& t_near) {
  const float tnx = ((OCT & 1 ? hi.x : lo.x) - ox) * ix;
  const float tfx = ((OCT & 1 ? lo.x : hi.x) - ox) * ix;
  const float tny = ((OCT & 2 ? hi.y : lo.y) - oy) * iy;
  const float tfy = ((OCT & 2 ? lo.y : hi.y) - oy) * iy;
  const float tnz = ((OCT & 4 ? hi.z : lo.z) - oz) * iz;
  const float tfz = ((OCT & 4 ? lo.z : hi.z) - oz) * iz;
  t_near = fmaxf(fmaxf(tnx, tny), tnz);
  const float t_far = fminf(fminf(tfx, tfy), tfz);
  return t_far >= 0.0f && t_far >= t_near;
}

struct WalkCount {
  int boxes, tris;
};

// Closest hit of `ray` (origin ox, oy, oz, direction dx, dy, dz and its
// leaf test hit(row, u, v) -> t > 0, or -1 without a hit): returns the
// distance (RESTIR_BIG on a miss) and sets prim (-1 on a miss) and the
// barycentrics (0 on a miss).
template <bool COUNT, class RayT>
__device__ __forceinline__ float closest_walk(const BvhRows& bvh,
                                              const RayT& ray, int& prim,
                                              float& bu, float& bv,
                                              WalkCount& n) {
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  float best = RESTIR_BIG;
  prim = -1;
  bu = bv = 0.0f;
  int node = 0;
  while (node < bvh.size) {
    const BvhNode nd = bvh.node(base + node);
    float t_near;
    const bool descend =
        slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
        t_near <= best * RESTIR_CULL_SLACK;
    if (COUNT) ++n.boxes;
    if (descend && nd.prim >= 0) {
      if (COUNT) ++n.tris;
      float u, v;
      const float t = ray.hit(bvh.planes + (size_t)nd.prim * 12, u, v);
      if (t >= 0.0f && (t < best || (t == best && nd.prim < prim))) {
        best = t;
        prim = nd.prim;
        bu = u;
        bv = v;
      }
    }
    node = descend ? node + 1 : nd.miss;
  }
  return best;
}

// Any hit of `ray` at 0 < t < limit on a triangle other than `self` (-1
// excludes none); stops at the first one. A limit <= 0 (a lane without a
// live winner) tests nothing.
template <bool COUNT, class RayT>
__device__ __forceinline__ bool occluded_walk(const BvhRows& bvh,
                                              const RayT& ray, float limit,
                                              int self, WalkCount& n) {
  if (!(limit > 0.0f)) return false;
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  const float cull = limit * RESTIR_CULL_SLACK;
  int node = 0;
  while (node < bvh.size) {
    const BvhNode nd = bvh.node(base + node);
    float t_near;
    const bool descend =
        slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
        t_near <= cull;
    if (COUNT) ++n.boxes;
    if (descend && nd.prim >= 0 && nd.prim != self) {
      if (COUNT) ++n.tris;
      float u, v;
      const float t = ray.hit(bvh.planes + (size_t)nd.prim * 12, u, v);
      if (t >= 0.0f && t < limit) return true;
    }
    node = descend ? node + 1 : nd.miss;
  }
  return false;
}

// The JAX package's own walk (restir_tpu/ops/intersect.py:145-280, XLA
// loops), kernels B13 and B14: node rows with each node's exact box (no
// padding, no cull slack), entry only while t_near < best (strictly), and
// the first hit found kept on ties (a later hit must be strictly nearer).
// RayT::hit(row, leaf) is the Moller-Trumbore test (`MtRay`,
// intersect.cu): t > 0 or -1, and leaf.bary(u, v) the barycentrics of that
// test, divided out only for a hit the walk keeps.
template <bool COUNT, class RayT>
__device__ __forceinline__ float exact_closest_walk(const BvhRows& bvh,
                                                    const RayT& ray,
                                                    int& prim, float& bu,
                                                    float& bv,
                                                    WalkCount& n) {
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  float best = __int_as_float(0x7f800000);
  prim = -1;
  bu = bv = 0.0f;
  int node = 0;
  if (nan_ray(ray)) {
    if (COUNT) ++n.boxes;
    node = bvh.size;
  }
  while (node < bvh.size) {
    const BvhNode nd = bvh.node(base + node);
    float t_near;
    const bool descend =
        slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
        t_near < best;
    if (COUNT) ++n.boxes;
    if (descend && nd.prim != -1) {
      if (COUNT) ++n.tris;
      typename RayT::Leaf leaf;
      const float t = ray.hit(bvh.planes + (size_t)nd.prim * 12, leaf);
      if (t > 0.0f && t < best) {
        best = t;
        prim = nd.prim;
        leaf.bary(bu, bv);
      }
    }
    node = descend ? node + 1 : nd.miss;
  }
  return best;
}

// Any hit at 0 < t < limit on the exact rows, stopping at the first one
// (test_occlusion_bvh: entry while t_near < limit, no self-primitive
// exclusion).
template <bool COUNT, class RayT>
__device__ __forceinline__ bool exact_occluded_walk(const BvhRows& bvh,
                                                    const RayT& ray,
                                                    float limit,
                                                    WalkCount& n) {
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  int node = 0;
  if (nan_ray(ray)) {
    if (COUNT) ++n.boxes;
    node = bvh.size;
  }
  while (node < bvh.size) {
    const BvhNode nd = bvh.node(base + node);
    float t_near;
    const bool descend =
        slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
        t_near < limit;
    if (COUNT) ++n.boxes;
    if (descend && nd.prim != -1) {
      if (COUNT) ++n.tris;
      typename RayT::Leaf leaf;
      const float t = ray.hit(bvh.planes + (size_t)nd.prim * 12, leaf);
      if (t > 0.0f && t < limit) return true;
    }
    node = descend ? node + 1 : nd.miss;
  }
  return false;
}

// A node row as the octant walks index it: one 32-byte unit, so a step's
// address is one multiply-add on the row index.
struct alignas(32) NodeRow {
  float4 lo, hi;
};

// What an octant walk keeps besides the best distance: B14's count of
// descended nodes (`step`), or B13's closest hit (`hit`: the primitive
// and, divided out only here, its barycentrics).
struct HeatKeep {
  int descended = 0;
  __device__ __forceinline__ void step(bool descend) {
    if (descend) ++descended;
  }
  template <class Leaf>
  __device__ __forceinline__ void hit(int, const Leaf&) {}
};

struct ClosestKeep {
  int prim = -1;
  float bu = 0.0f, bv = 0.0f;
  __device__ __forceinline__ void step(bool) {}
  template <class Leaf>
  __device__ __forceinline__ void hit(int p, const Leaf& leaf) {
    prim = p;
    leaf.bary(bu, bv);
  }
};

// One octant's loop (OCT as octant_slab's, or -1: `slab`):
// exact_closest_walk's decisions on the table of rows [base, base +
// size), returning the best distance (inf on a miss) and telling `keep`
// each step and each kept hit. It steps the row index itself, so a
// step's address and bound need no per-step offset.
template <bool COUNT, int OCT, class RayT, class Keep>
__device__ __forceinline__ float octant_loop(const NodeRow* __restrict__ rows,
                                             int base, int size,
                                             const float* __restrict__ leaves,
                                             const RayT& ray, float ix,
                                             float iy, float iz, Keep& keep,
                                             WalkCount& n) {
  float best = __int_as_float(0x7f800000);
  int row = base;
  const int end = base + size;
  while (row < end) {
    const NodeRow* q = rows + row;
    const float4 lo = __ldg(&q->lo), hi = __ldg(&q->hi);
    float t_near;
    bool box;
    if constexpr (OCT < 0)
      box = slab(lo, hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near);
    else
      box = octant_slab<OCT>(lo, hi, ray.ox, ray.oy, ray.oz, ix, iy, iz,
                             t_near);
    const bool descend = box && t_near < best;
    if (COUNT) ++n.boxes;
    const int prim = __float_as_int(lo.w);
    if (descend && prim != -1) {
      if (COUNT) ++n.tris;
      typename RayT::Leaf leaf;
      const float t = ray.hit(leaves + (size_t)prim * 12, leaf);
      if (t > 0.0f && t < best) {
        best = t;
        keep.hit(prim, leaf);
      }
    }
    keep.step(descend);
    row = descend ? row + 1 : base + __float_as_int(hi.w);
  }
  return best;
}

// exact_closest_walk's decisions for `ray`, each ray on the loop of its
// inverse direction's octant; a ray with an infinite direction component
// (a zero inverse) or origin component runs the `slab` loop, since
// (lo - o) * i can be NaN on one plane only there; a ray with a NaN
// component ends at its start (nan_ray). A warp whose lanes take several
// loops runs them one after another, so B13's closest hit sorts its rays
// by this choice first (sort.cu, the ray key).
// The tables' 6B rows fit an int (BvhRows::size is one).
template <bool COUNT, class RayT, class Keep>
__device__ __forceinline__ float octant_walk(const BvhRows& bvh,
                                             const RayT& ray, Keep& keep,
                                             WalkCount& n) {
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const NodeRow* rows = reinterpret_cast<const NodeRow*>(bvh.rows);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  const bool min_max = ix == 0.0f || iy == 0.0f || iz == 0.0f ||
                       isinf(ray.ox) || isinf(ray.oy) || isinf(ray.oz);
  const int oct = (signbit(ix) ? 1 : 0) | (signbit(iy) ? 2 : 0) |
                  (signbit(iz) ? 4 : 0);
#define RESTIR_OCTANT(O)                                                    \
  octant_loop<COUNT, O>(rows, base, bvh.size, bvh.planes, ray, ix, iy, iz, \
                        keep, n)
  if (nan_ray(ray)) {
    if (COUNT) ++n.boxes;
    return __int_as_float(0x7f800000);
  }
  if (min_max) return RESTIR_OCTANT(-1);
  switch (oct) {
    case 0: return RESTIR_OCTANT(0);
    case 1: return RESTIR_OCTANT(1);
    case 2: return RESTIR_OCTANT(2);
    case 3: return RESTIR_OCTANT(3);
    case 4: return RESTIR_OCTANT(4);
    case 5: return RESTIR_OCTANT(5);
    case 6: return RESTIR_OCTANT(6);
    default: return RESTIR_OCTANT(7);
  }
#undef RESTIR_OCTANT
}

// The BVH heatmap's value (intersect_visualize): the number of nodes
// exact_closest_walk descends for `ray`, each decision the same.
template <bool COUNT, class RayT>
__device__ __forceinline__ int heat_walk(const BvhRows& bvh, const RayT& ray,
                                         WalkCount& n) {
  HeatKeep keep;
  octant_walk<COUNT>(bvh, ray, keep, n);
  return keep.descended;
}

// exact_closest_walk's result (distance, prim, barycentrics) on the
// octant loops.
template <bool COUNT, class RayT>
__device__ __forceinline__ float octant_closest_walk(const BvhRows& bvh,
                                                     const RayT& ray,
                                                     int& prim, float& bu,
                                                     float& bv,
                                                     WalkCount& n) {
  ClosestKeep keep;
  const float best = octant_walk<COUNT>(bvh, ray, keep, n);
  prim = keep.prim;
  bu = keep.bu;
  bv = keep.bv;
  return best;
}

}  // namespace restir
