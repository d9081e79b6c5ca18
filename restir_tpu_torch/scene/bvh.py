"""SAH BVH + MTBVH (multi-threaded BVH) build, on the host in numpy.

The same builder as `restir_tpu.scene.bvh._build_bvh_numpy`, operation for
operation (stable argsorts, `np.minimum.at` bucket bounds, the SAH lerp),
so the trees are bit-identical to the JAX package's:

- flattened preorder binary BVH, one primitive per leaf, size 2N-1; the
  node at `offset` has its left child at `offset+1` and its right child
  at `offset+1+left_subtree_size`;
- 16-bucket binned SAH split on the longest centroid axis;
- 6 re-ordered traversal tables, one per dominant direction (+x, -x, +y,
  -y, +z, -z), each node = {prim_id, box_id, miss}: children come
  near-to-far for that direction and `miss` jumps over the subtree, so a
  traversal is one stackless loop (the CUDA original's scene.h:245-316).

`build_bvh(impl="auto")` takes the native C++ builder
(`native/bvh_native.py`: a copy of `restir_tpu/native/bvh.cpp` whose SAH
areas round as this builder's do, built with g++ on first use), which
returns the same tree bit for bit; where g++ is missing it warns once and
takes this numpy builder, which takes 6-11 s for the 81k-triangle hall
on one CPU core.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

NULL_PRIMITIVE = -1
NUM_BUCKETS = 16


class BVH(NamedTuple):
    """Host-side BVH arrays (numpy). B = 2N-1 nodes."""

    bounds_lo: np.ndarray  # [B, 3] float32
    bounds_hi: np.ndarray  # [B, 3] float32
    prim_id: np.ndarray  # [6, B] int32, NULL_PRIMITIVE for inner nodes
    box_id: np.ndarray  # [6, B] int32: index into the bounds arrays
    miss: np.ndarray  # [6, B] int32: next node if this node's box missed
    size: int  # B


_warned_numpy = False


def build_bvh(vertices: np.ndarray, impl: str = "auto") -> BVH:
    """vertices: [3N, 3] float32 world-space triangle soup. `impl`:
    "native" (the C++ builder; raises where it cannot be compiled),
    "numpy", or "auto": native, and numpy with a warning given once per
    process only where g++ is missing."""
    global _warned_numpy
    if impl == "numpy":
        return _build_bvh_numpy(vertices)
    if impl not in ("auto", "native"):
        raise ValueError(f"unknown BVH builder {impl!r}")
    from ..native import bvh_native

    try:
        return bvh_native.build_bvh_native(vertices)
    except bvh_native.ToolchainMissing as e:
        if impl == "native":
            raise
        if not _warned_numpy:
            _warned_numpy = True
            warnings.warn(f"restir_tpu_torch: {e}; building BVHs with "
                          "the (slower) numpy builder", stacklevel=2)
        return _build_bvh_numpy(vertices)


def _build_bvh_numpy(vertices: np.ndarray) -> BVH:
    verts = np.asarray(vertices, np.float32).reshape(-1, 3, 3)
    n = verts.shape[0]
    if n < 1:
        raise ValueError("BVH of an empty scene")
    if n == 1:
        # degenerate single-leaf tree
        lo = verts[0].min(0)[None]
        hi = verts[0].max(0)[None]
        prim = np.zeros((6, 1), np.int32)
        box = np.zeros((6, 1), np.int32)
        miss = np.ones((6, 1), np.int32)
        return BVH(lo, hi, prim, box, miss, 1)

    size = 2 * n - 1
    prim_lo = verts.min(axis=1)
    prim_hi = verts.max(axis=1)
    centers = (prim_lo + prim_hi) * 0.5

    bounds_lo = np.empty((size, 3), np.float32)
    bounds_hi = np.empty((size, 3), np.float32)
    # is_leaf + (prim id for leaves | subtree node count for inner)
    leaf_flag = np.zeros(size, bool)
    payload = np.zeros(size, np.int64)

    order = np.arange(n)  # permutation of primitives, partitioned in place
    stack = [(0, 0, n - 1)]  # (node offset, start prim, end prim) inclusive

    while stack:
        offset, start, end = stack.pop()
        m = end - start + 1
        node_size = 2 * m - 1
        ids = order[start:end + 1]

        lo = prim_lo[ids]
        hi = prim_hi[ids]
        bounds_lo[offset] = lo.min(0)
        bounds_hi[offset] = hi.max(0)

        if m == 1:
            leaf_flag[offset] = True
            payload[offset] = ids[0]
            continue
        payload[offset] = node_size

        ctr = centers[ids]
        c_lo, c_hi = ctr.min(0), ctr.max(0)
        axis = int(np.argmax(c_hi - c_lo))
        extent = c_hi[axis] - c_lo[axis]

        if extent <= 0.0 or not np.isfinite(extent):
            # all centroids identical: median split
            div_local = m // 2 - 1
            part = np.argsort(ctr[:, axis], kind="stable")
            order[start:end + 1] = ids[part]
        else:
            rel = (ctr[:, axis] - c_lo[axis]) / extent * NUM_BUCKETS
            bid = np.clip(rel.astype(np.int64), 0, NUM_BUCKETS - 1)

            counts = np.bincount(bid, minlength=NUM_BUCKETS)
            blo = np.full((NUM_BUCKETS, 3), np.inf, np.float32)
            bhi = np.full((NUM_BUCKETS, 3), -np.inf, np.float32)
            np.minimum.at(blo, bid, lo)
            np.maximum.at(bhi, bid, hi)

            # prefix/suffix unions
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]

            def area(lo_a, hi_a):
                d = np.maximum(hi_a - lo_a, 0.0)
                return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                              + d[:, 2] * d[:, 0])

            cprefix = np.cumsum(counts)
            # SAH cost of splitting after bucket i (the CUDA original's
            # lerp form, bvh.cpp:104-106): mix(SA_L, SA_R, n_left/m)
            frac = cprefix[:-1] / m
            sah = (area(llo[:-1], lhi[:-1]) * (1 - frac)
                   + area(rlo[1:], rhi[1:]) * frac)
            div_bucket = int(np.argmin(sah))

            left_mask = bid <= div_bucket
            div_local = int(left_mask.sum()) - 1
            div_local = min(max(div_local, 0), m - 2)
            part = np.argsort(~left_mask, kind="stable")
            order[start:end + 1] = ids[part]

        div = start + div_local
        l_size = 2 * (div - start + 1) - 1
        stack.append((offset + 1 + l_size, div + 1, end))
        stack.append((offset + 1, start, div))

    mt_prim, mt_box, mt_miss = _build_mtbvh_layouts(
        bounds_lo, bounds_hi, leaf_flag, payload, size)
    return BVH(bounds_lo, bounds_hi, mt_prim, mt_box, mt_miss, size)


def _build_mtbvh_layouts(bounds_lo, bounds_hi, leaf_flag, payload, size):
    """Six direction-ordered stackless tables (bvh.cpp:133-193)."""
    centers = (bounds_lo + bounds_hi) * 0.5
    mt_prim = np.empty((6, size), np.int32)
    mt_box = np.empty((6, size), np.int32)
    mt_miss = np.empty((6, size), np.int32)

    for d in range(6):
        dim = d // 2
        lesser = bool(d & 1)
        stack = [0]
        new_id = 0
        while stack:
            orig = stack.pop()
            is_leaf = leaf_flag[orig]
            node_size = 1 if is_leaf else payload[orig]

            mt_prim[d, new_id] = payload[orig] if is_leaf else NULL_PRIMITIVE
            mt_box[d, new_id] = orig
            mt_miss[d, new_id] = new_id + node_size
            new_id += 1

            if is_leaf:
                continue
            left = orig + 1
            left_size = 1 if leaf_flag[left] else payload[left]
            right = left + left_size
            if (centers[left, dim] < centers[right, dim]) != lesser:
                left, right = right, left
            stack.append(right)
            stack.append(left)

    return mt_prim, mt_box, mt_miss


def get_mtbvh_id(dx, dy, dz):
    """Dominant-axis table index for a direction (scene.h:101-119), as
    int32 torch tensors: +x 0, -x 1, +y 2, -y 3, +z 4, -z 5. The CUDA
    original indexes the tables with the NEGATED ray direction
    (scene.h:250): callers pass -d."""
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    id_x = torch.where(dx > 0, 0, 1)
    id_y = torch.where(dy > 0, 2, 3)
    id_z = torch.where(dz > 0, 4, 5)
    return torch.where((ax > ay) & (ax > az), id_x,
                       torch.where((ay >= ax) & (ay > az), id_y,
                                   id_z)).to(torch.int32)
