"""Ray intersection of the general path, as `restir_tpu.ops.intersect`.

`traversal_arrays` resolves the intersector as the JAX package does
(`scene.scene_data.traversal_method`): "brute" (and "auto" up to
16,384 triangles) takes the brute-force method, every
other name the lockstep MTBVH walk with the Möller-Trumbore leaf test.
`intersect_closest` and `test_occlusion` dispatch on `trv.method`
(`ops.kernels.intersect`): brute force is kernel B11 on CUDA tensors
(an MTBVH walk that returns the brute force's hits bit for bit) and
`intersect_bf` on CPU tensors; the walk is kernel B13 on CUDA tensors
and its plain twins below on CPU tensors.

The twins `intersect_closest_bvh`, `test_occlusion_bvh` and
`intersect_visualize` (the BVH heatmap's per-ray count of descended
nodes; kernel B14 on the card) mirror the JAX loops line for line:
unpadded node boxes, entry strictly before the best hit (or the shadow
limit), ties to the first hit in walk order, `inf` on a miss, and the
any hit without a self-primitive exclusion. Each step advances every
live ray by one node; lanes that finish leave the batch, which changes
no lane's result. The loop bodies run inside `utils.math.fused()`, as
XLA compiles the JAX `while_loop` bodies, so on CPU tensors they round
as the JAX package does; on CUDA tensors they take plain float32 ops,
which the kernels repeat.

`intersect_triangle` (Möller-Trumbore) and `brute_force_closest` are the
test oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..scene.bvh import get_mtbvh_id
from ..scene.scene_data import traversal_method
from ..utils import math as mathx
from .kernels import intersect as kernels
from .kernels.tables import WalkTables

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # intersections.h:13-15
OCCLUSION_EPS = 1e-4  # scene.h:287


class Hit(NamedTuple):
    prim_id: torch.Tensor  # [R] int32, NULL_PRIMITIVE on a miss
    dist: torch.Tensor  # [R] float32 (inf on a miss)
    bary: torch.Tensor  # [R, 2] weights of (v1, v2)


class TraversalArrays(NamedTuple):
    """What the intersector reads of a scene."""

    tri_xform: torch.Tensor  # [4, 3N] unit-triangle transforms (plain version)
    planes: torch.Tensor  # [n_pad, 12] the same, as the kernels' plane rows
    rows: torch.Tensor  # [6B, 8] MTBVH node rows B11 / B12 walk
    size: int  # B, nodes per MTBVH table
    method: str = "brute"  # "brute", or any other name: the MTBVH walk
    walk: Optional[WalkTables] = None  # the walk's tables (B13, B14)


def traversal_arrays(scene, intersector: str = "auto",
                     walk: bool = False) -> TraversalArrays:
    """The intersector arrays of `scene` for `intersector`
    (scene_data.traversal_arrays); the walk's tables come with every
    method but "brute", and with `walk` (the heatmap walks on any
    method)."""
    method = traversal_method(scene, intersector)
    tables = scene.walk.get() if walk or method != "brute" else None
    return TraversalArrays(tri_xform=scene.tri_xform,
                           planes=scene.bvh.planes, rows=scene.bvh.rows,
                           size=scene.bvh.size, method=method, walk=tables)


def make_offseted_ray(origin, direction):
    """origin += dir * 1e-5 — intersections.h:13."""
    return mathx.muladd(direction, RAY_OFFSET, origin), direction


def intersect_closest(trv: TraversalArrays, o, d, active=None) -> Hit:
    """Closest hit of every ray; inactive lanes miss."""
    prim, dist, bary = kernels.closest_hit(trv, o, d, active)
    return Hit(prim_id=prim, dist=dist, bary=bary)


def test_occlusion(trv: TraversalArrays, x, y, active=None,
                   geom=None) -> torch.Tensor:
    """Any hit between points x and y (bool [R]); inactive lanes False.
    `geom` (width, pix0): one segment per pixel from global pixel pix0 of
    a frame `width` wide (B13's launch)."""
    return kernels.any_hit(trv, x, y, active, geom)


def intersect_triangle(o, d, v0, v1, v2):
    """Möller-Trumbore with the reference's sign flip
    (intersections.h:17-54) -> (hit, dist, bary [..., 2])."""
    e01 = v1 - v0
    e02 = v2 - v0
    p = mathx.cross(d, e02)
    det = mathx.dot(p, e01)
    nondegenerate = torch.abs(det) >= torch.finfo(torch.float32).eps
    v0_to_o = o - v0
    flip = det < 0.0
    det = torch.abs(det)
    v0_to_o = torch.where(flip[..., None], -v0_to_o, v0_to_o)
    # XLA's compiled CPU code leaves this dot uncontracted (its operand is
    # a select): products rounded, summed left to right, even in fused()
    q = v0_to_o * p
    bx = q[..., 0] + q[..., 1] + q[..., 2]
    perp = mathx.cross(v0_to_o, e01)
    by = mathx.dot(d, perp)
    inside = (bx >= 0.0) & (bx <= det) & (by >= 0.0) & (bx + by <= det)
    det_safe = torch.where(det > 0, det, 1.0)
    dist = mathx.dot(e02, perp) / det_safe
    bary = torch.stack([bx, by], dim=-1) / det_safe[..., None]
    return nondegenerate & inside & (dist > 0.0), dist, bary


def intersect_aabb(o, d, lo, hi):
    """Slab test (bvh.h:85-157 as a min / max test) -> (hit, t_near);
    t_near is negative when the origin is inside the box."""
    tiny = 1e-12
    d_safe = torch.where(torch.abs(d) < tiny,
                         torch.where(d < 0, -tiny, tiny), d)
    inv = 1.0 / d_safe
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    return (t_far >= 0.0) & (t_far >= t_near), t_near


def _start(w: WalkTables, o, d, active):
    """(table base per ray, node cursors, live lanes): inactive lanes
    start parked at `size`."""
    base = get_mtbvh_id(-d[:, 0], -d[:, 1], -d[:, 2]).long() * w.size
    node = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    if active is not None:
        node = torch.where(active, node, w.size)
    return base, node, torch.nonzero(node < w.size)[:, 0]


def _visit(w: WalkTables, cursor, o, d, bound):
    """One node per live ray: (prim, miss, descend) with
    descend = box hit and t_near < bound."""
    prim = w.prim_flat[cursor].long()
    box = w.box_flat[cursor].long()
    box_hit, box_t = intersect_aabb(o, d, w.bounds_lo[box], w.bounds_hi[box])
    return prim, w.miss_flat[cursor].long(), box_hit & (box_t < bound)


def _leaf_test(w: WalkTables, prim, o, d):
    tri = w.verts[prim]
    return intersect_triangle(o, d, tri[:, 0], tri[:, 1], tri[:, 2])


def _closest(w: WalkTables, o, d, active, count: bool):
    """The closest-hit walk -> (prim, dist, bary, descended-node count)."""
    r = o.shape[0]
    base, node, live = _start(w, o, d, active)
    best_dist = torch.full((r,), torch.inf, device=o.device)
    best_prim = torch.full((r,), NULL_PRIMITIVE, dtype=torch.int64,
                           device=o.device)
    best_bary = torch.zeros((r, 2), device=o.device)
    visits = torch.zeros((r,), dtype=torch.int32, device=o.device)
    with mathx.fused():  # a while_loop body in the JAX package
        while live.numel():
            ol, dl = o[live], d[live]
            prim, miss, descend = _visit(w, base[live] + node[live], ol, dl,
                                         best_dist[live])
            if count:
                visits[live] += descend.to(torch.int32)
            leaf = descend & (prim != NULL_PRIMITIVE)
            lanes = live[leaf]
            t_hit, t_dist, t_bary = _leaf_test(w, prim[leaf], ol[leaf],
                                               dl[leaf])
            closer = t_hit & (t_dist < best_dist[lanes])
            win = lanes[closer]
            best_dist[win] = t_dist[closer]
            best_prim[win] = prim[leaf][closer]
            best_bary[win] = t_bary[closer]
            node[live] = torch.where(descend, node[live] + 1, miss)
            live = live[node[live] < w.size]
    return best_prim.to(torch.int32), best_dist, best_bary, visits


def intersect_closest_bvh(w: WalkTables, o, d, active=None):
    """Closest hit of every ray (scene.h:245-284 in lockstep form) ->
    (prim [R] i32, dist [R], bary [R, 2]); inactive lanes are not walked
    and miss (prim -1, dist inf)."""
    return _closest(w, o, d, active, count=False)[:3]


def intersect_visualize(w: WalkTables, o, d) -> torch.Tensor:
    """BVH heatmap: the per-ray count of descended nodes (int32 [R]) —
    scene.h:318-356."""
    return _closest(w, o, d, None, count=True)[3]


def test_occlusion_bvh(w: WalkTables, x, y, active=None) -> torch.Tensor:
    """Any hit between points x and y — scene.h:286-316 (bool [R]: True
    is occluded); inactive lanes read False without walking."""
    seg = y - x
    dist = mathx.length(seg)
    d = seg / torch.clamp(dist, min=1e-20)[..., None]
    o, d = make_offseted_ray(x, d)
    limit = dist - OCCLUSION_EPS * 2.0
    base, node, live = _start(w, o, d, active)
    occluded = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    with mathx.fused():  # a while_loop body in the JAX package
        while live.numel():
            ol, dl, lim = o[live], d[live], limit[live]
            prim, miss, descend = _visit(w, base[live] + node[live], ol, dl,
                                         lim)
            leaf = descend & (prim != NULL_PRIMITIVE)
            t_hit, t_dist, _ = _leaf_test(w, prim[leaf], ol[leaf], dl[leaf])
            occluded[live[leaf][t_hit & (t_dist < lim[leaf])]] = True
            # occluded rays stop at once (scene.h:305-307)
            node[live] = torch.where(descend, node[live] + 1, miss)
            live = live[(node[live] < w.size) & ~occluded[live]]
    return occluded


def brute_force_closest(verts, o, d) -> Hit:
    """O(N R) oracle over the triangle soup (naiveIntersect,
    scene.h:200-225). Test use."""
    r = o.shape[0]
    best_dist = torch.full((r,), torch.inf, device=o.device)
    best_prim = torch.full((r,), NULL_PRIMITIVE, dtype=torch.int32,
                           device=o.device)
    best_bary = torch.zeros((r, 2), device=o.device)
    for i in range(verts.shape[0]):
        tri = verts[i]
        hit, dist, bary = intersect_triangle(o, d, tri[0], tri[1], tri[2])
        closer = hit & (dist < best_dist)
        best_dist = torch.where(closer, dist, best_dist)
        best_prim = torch.where(closer, i, best_prim)
        best_bary = torch.where(closer[..., None], bary, best_bary)
    return Hit(prim_id=best_prim, dist=best_dist, bary=best_bary)
