// Stage probes of the shadow walks of B7 (reuse_bvh.cu) and B10
// (ris_cdf.cu), for restir_tpu_torch/prof (prof_vissplit, prof_hallsplit).
//
// Port of the stub modes of the TPU probes prof/prof_vissplit.py:303 (the
// vis kernel's DMA wait, compute and loop, each alone) and
// prof/prof_hallsplit.py:186 (early exit on / off). A build of those
// sources with -DPROBE_WALK=<mode> calls probe_occluded_walk<mode> in
// place of bvh.cuh's occluded_walk:
//   1 "search-only": no walk (the pixel's RIS alone; nothing occluded);
//   2 "fixed-node":  as many box tests and leaf tests as the full walk
//      made for this ray (n holds them on entry: the COUNT build's
//      counts), on two node rows and two plane rows that stay in L1, so
//      no load waits on the one before it: the walk's arithmetic and
//      issue without its dependent-load latency;
//   3 "no-leaf":     the walk with its box tests only (no triangle is
//      tested, so no ray stops early);
//   4 "no-exit":     the full walk, which notes a hit and walks on to the
//      end of the table (its occlusion is the full walk's).
// Modes 3 and 4 count their box and leaf tests into n, which a counting
// launch (stats) writes out: the work their bounds count.
// Modes 1-3 write packs that are not B7's / B10's; mode 4 writes theirs.
// Without PROBE_WALK nothing of this file is compiled.
#pragma once

#include "../bvh.cuh"

namespace restir {

template <int MODE, class RayT>
__device__ __forceinline__ bool probe_occluded_walk(const BvhRows& bvh,
                                                    const RayT& ray,
                                                    float limit, int self,
                                                    WalkCount& n) {
  if (MODE == 1) return false;
  if (!(limit > 0.0f)) return false;
  const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy),
              iz = safe_inv(ray.dz);
  const int base = mtbvh_id(-ray.dx, -ray.dy, -ray.dz) * bvh.size;
  const float cull = limit * RESTIR_CULL_SLACK;
  if (MODE == 2) {
    // the addresses come from the step count, not from the last load
    float acc = 0.0f;
    for (int i = 0; i < n.boxes; ++i) {
      const BvhNode nd = bvh.node(base + (i & 1));
      float t_near;
      const bool descend =
          slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
          t_near <= cull;
      acc += descend ? t_near : 1.0f;
    }
    for (int j = 0; j < n.tris; ++j) {
      float u, v;
      const float t = ray.hit(bvh.planes + (size_t)(j & 1) * 12, u, v);
      acc += t + u + v;
    }
    return __float_as_int(acc) == 0x7fc00001;  // never: keeps acc live
  }
  bool hit = false;
  float acc = 0.0f;
  int node = 0;
  while (node < bvh.size) {
    const BvhNode nd = bvh.node(base + node);
    float t_near;
    const bool descend =
        slab(nd.lo, nd.hi, ray.ox, ray.oy, ray.oz, ix, iy, iz, t_near) &&
        t_near <= cull;
    ++n.boxes;
    if (MODE == 3) {
      acc += descend ? t_near : 0.0f;
    } else if (descend && nd.prim >= 0 && nd.prim != self) {
      ++n.tris;
      float u, v;
      const float t = ray.hit(bvh.planes + (size_t)nd.prim * 12, u, v);
      if (t >= 0.0f && t < limit) hit = true;
    }
    node = descend ? node + 1 : nd.miss;
  }
  if (MODE == 3) return __float_as_int(acc) == 0x7fc00001;
  return hit;
}

}  // namespace restir
