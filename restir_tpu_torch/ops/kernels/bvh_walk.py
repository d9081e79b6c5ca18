"""Lockstep PyTorch walks of the MTBVH, mirroring `csrc/bvh.cuh`.

Every ray advances one node per step through the same padded-box slab
test, cull slack, leaf test and tie rule as the CUDA walks, so the hits
equal the brute-force twins' and the per-ray box and triangle test
counts equal the kernels' wherever the float arithmetic does. The leaf
test is an argument: `di_plane` (the default) is `di_core.cuh`'s, the
arithmetic of `fused_di.closest_brute` / `occluded_brute` (B1, B6, B7);
`gi_plane` is `gi_core.cuh`'s, the arithmetic of `ops.intersect_bf` (B8
and its twin). Tests use the walks to hold the traversal (and its table
choice) against the brute force, and `chip_smoke.py` to count the walks'
work on a sample of the frame. The render path never calls them.
"""

from __future__ import annotations

import torch

from ...scene.bvh import get_mtbvh_id
from ...utils.math import fma
from .fused_di import BIG, _fma32
from .tables import BvhTables

CULL_SLACK = 1.0001220703125  # 1 + 2^-13, RESTIR_CULL_SLACK in bvh.cuh


def _safe_inv(d):
    tiny = torch.where(d < 0.0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _start(bvh: BvhTables, d):
    dx, dy, dz = d
    table = get_mtbvh_id(-dx, -dy, -dz).to(torch.int64)
    return table * bvh.size, tuple(_safe_inv(c) for c in d)


def _step(bvh: BvhTables, base, node, o, inv):
    """One node per ray: ((prim, miss) [a, 2] int64, slab hit, t_near)."""
    box = bvh.rows[base + node]
    nd = box[:, 3::4].contiguous().view(torch.int32).to(torch.int64)
    t_lo, t_hi = [], []
    for ax in range(3):
        t1 = (box[:, ax] - o[ax]) * inv[ax]
        t2 = (box[:, 4 + ax] - o[ax]) * inv[ax]
        t_lo.append(torch.minimum(t1, t2))
        t_hi.append(torch.maximum(t1, t2))
    t_near = torch.maximum(torch.maximum(t_lo[0], t_lo[1]), t_lo[2])
    t_far = torch.minimum(torch.minimum(t_hi[0], t_hi[1]), t_hi[2])
    return nd, (t_far >= 0.0) & (t_far >= t_near), t_near


def _hit(nondeg, t, u, v):
    hit = nondeg & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(hit, t, -1.0), u, v


def di_plane(planes, prim, o, d):
    """The unit-plane test of rows `prim` (fused_di.closest_brute's
    arithmetic, one row per ray): (t or -1, u, v)."""
    q = planes[prim]
    ox, oy, oz = o
    dx, dy, dz = d
    oou = q[:, 0] * ox + q[:, 1] * oy + q[:, 2] * oz + q[:, 3]
    oov = q[:, 4] * ox + q[:, 5] * oy + q[:, 6] * oz + q[:, 7]
    oow = q[:, 8] * ox + q[:, 9] * oy + q[:, 10] * oz + q[:, 11]
    ddu = q[:, 0] * dx + q[:, 1] * dy + q[:, 2] * dz
    ddv = q[:, 4] * dx + q[:, 5] * dy + q[:, 6] * dz
    ddw = q[:, 8] * dx + q[:, 9] * dy + q[:, 10] * dz
    nondeg = torch.abs(ddw) >= 1e-12
    t = -oow / torch.where(nondeg, ddw, 1.0)
    return _hit(nondeg, t, oou + t * ddu, oov + t * ddv)


def gi_plane(planes, prim, o, d):
    """The unit-plane test of rows `prim` as `ops.intersect_bf` computes
    it, one row per ray: the dots of the float32 product [o, 1] @ xform
    as one FMA per term in index order (how the product accumulates on
    the CPU and on the card, and `gi_core.cuh`'s fmaf chains), u and v
    through `utils.math.fma`: (t or -1, u, v)."""
    q = planes[prim]

    def dots(c, x):
        acc = q[:, c] * x[0]
        return _fma32(q[:, c + 2], x[2], _fma32(q[:, c + 1], x[1], acc))

    oou, oov, oow = (dots(c, o) + q[:, c + 3] for c in (0, 4, 8))
    ddu, ddv, ddw = (dots(c, d) for c in (0, 4, 8))
    nondeg = torch.abs(ddw) >= 1e-12
    t = -oow / torch.where(nondeg, ddw, 1.0)
    return _hit(nondeg, t, fma(t, ddu, oou), fma(t, ddv, oov))


def closest_walk(bvh: BvhTables, o, d, plane=di_plane):
    """Closest hit of rays (o, d) ((x, y, z) tuples of [R] tensors) under
    the leaf test `plane`: (dist, prim int32, u, v, boxes, tris) with BIG
    / -1 / 0 / 0 on a miss and the int32 counts of box and triangle tests
    per ray."""
    n = d[0].shape[0]
    dev = d[0].device
    base, inv = _start(bvh, d)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    boxes = torch.zeros(n, dtype=torch.int32, device=dev)
    tris = torch.zeros(n, dtype=torch.int32, device=dev)
    live = torch.arange(n, device=dev)
    while live.numel():
        oa = tuple(c[live] for c in o)
        nd, hit, t_near = _step(bvh, base[live], node[live], oa,
                                tuple(c[live] for c in inv))
        descend = hit & (t_near <= best[live] * CULL_SLACK)
        boxes[live] += 1
        leaf = descend & (nd[:, 0] >= 0)
        lanes = live[leaf]
        tris[lanes] += 1
        pid = nd[leaf, 0]
        t, u, v = plane(bvh.planes, pid, tuple(c[leaf] for c in oa),
                        tuple(c[lanes] for c in d))
        cur = best[lanes]
        better = (t >= 0.0) & ((t < cur) | ((t == cur) & (pid < prim[lanes])))
        win = lanes[better]
        best[win] = t[better]
        prim[win] = pid[better]
        bu[win] = u[better]
        bv[win] = v[better]
        node[live] = torch.where(descend, node[live] + 1, nd[:, 1])
        live = live[node[live] < bvh.size]
    return best, prim.to(torch.int32), bu, bv, boxes, tris


def occluded_walk(bvh: BvhTables, o, d, limit, self_prim, plane=di_plane):
    """Any hit at 0 < t < limit on a triangle other than `self_prim` (-1
    excludes none) under the leaf test `plane`, with the CUDA walk's early
    exit: (occluded bool, boxes, tris)."""
    n = d[0].shape[0]
    dev = d[0].device
    base, inv = _start(bvh, d)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    boxes = torch.zeros(n, dtype=torch.int32, device=dev)
    tris = torch.zeros(n, dtype=torch.int32, device=dev)
    cull = limit * CULL_SLACK
    self_prim = self_prim.to(torch.int64)
    live = torch.nonzero(limit > 0.0)[:, 0]
    while live.numel():
        oa = tuple(c[live] for c in o)
        nd, hit, t_near = _step(bvh, base[live], node[live], oa,
                                tuple(c[live] for c in inv))
        descend = hit & (t_near <= cull[live])
        boxes[live] += 1
        leaf = descend & (nd[:, 0] >= 0) & (nd[:, 0] != self_prim[live])
        lanes = live[leaf]
        tris[lanes] += 1
        t, _, _ = plane(bvh.planes, nd[leaf, 0], tuple(c[leaf] for c in oa),
                        tuple(c[lanes] for c in d))
        occ[lanes[(t >= 0.0) & (t < limit[lanes])]] = True
        node[live] = torch.where(descend, node[live] + 1, nd[:, 1])
        live = live[(node[live] < bvh.size) & ~occ[live]]
    return occ, boxes, tris
