"""Ray intersection of the general path, as `restir_tpu.ops.intersect`.

The port carries the brute-force method's results (scenes of at most
`BRUTE_FORCE_MAX_PRIMS` triangles): `intersect_closest` and
`test_occlusion` take kernel B11 (`ops.kernels.intersect`) on CUDA
tensors, which walks the scene's MTBVH with the brute force's plane test
and returns its hits bit for bit, and its plain version (`intersect_bf`,
the JAX package's CPU route, every triangle row) on CPU tensors. The
lockstep Moller-Trumbore MTBVH walk of the JAX general path
(`intersector="bvh"`, and "auto" above the brute-force limit) is not
ported: it raises, naming ROADMAP Queue A 7.

`intersect_triangle` (Möller-Trumbore) and `brute_force_closest` are the
test oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import intersect as kernels

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # intersections.h:13-15
OCCLUSION_EPS = 1e-4  # scene.h:287
BRUTE_FORCE_MAX_PRIMS = 16384  # scene_data.BRUTE_FORCE_MAX_PRIMS


class Hit(NamedTuple):
    prim_id: torch.Tensor  # [R] int32, NULL_PRIMITIVE on a miss
    dist: torch.Tensor  # [R] float32 (inf on a miss)
    bary: torch.Tensor  # [R, 2] weights of (v1, v2)


class TraversalArrays(NamedTuple):
    """What the intersector reads of a scene."""

    tri_xform: torch.Tensor  # [4, 3N] unit-triangle transforms (plain version)
    planes: torch.Tensor  # [n_pad, 12] the same, as the kernels' plane rows
    rows: torch.Tensor  # [6B, 8] MTBVH node rows the kernels walk
    size: int  # B, nodes per MTBVH table
    method: str = "brute"


def traversal_arrays(scene, intersector: str = "auto") -> TraversalArrays:
    """Resolve the intersector for a scene (scene_data.traversal_arrays):
    "auto" and "brute" take the brute-force method up to
    BRUTE_FORCE_MAX_PRIMS triangles."""
    n = scene.num_tris
    if intersector not in ("auto", "brute") or n > BRUTE_FORCE_MAX_PRIMS:
        raise NotImplementedError(
            f"intersector {intersector!r} on {n} triangles: the general "
            "path's MTBVH walk is not ported yet (ROADMAP Queue A 7); the "
            f"brute-force method takes up to {BRUTE_FORCE_MAX_PRIMS}")
    return TraversalArrays(tri_xform=scene.tri_xform,
                           planes=scene.bvh.planes, rows=scene.bvh.rows,
                           size=scene.bvh.size)


def make_offseted_ray(origin, direction):
    """origin += dir * 1e-5 — intersections.h:13."""
    from ..utils.math import muladd

    return muladd(direction, RAY_OFFSET, origin), direction


def intersect_closest(trv: TraversalArrays, o, d, active=None) -> Hit:
    """Closest hit of every ray; inactive lanes miss."""
    prim, dist, bary = kernels.closest_hit(trv, o, d, active)
    return Hit(prim_id=prim, dist=dist, bary=bary)


def test_occlusion(trv: TraversalArrays, x, y, active=None) -> torch.Tensor:
    """Any hit between points x and y (bool [R]); inactive lanes False."""
    return kernels.any_hit(trv, x, y, active)


def intersect_triangle(o, d, v0, v1, v2):
    """Möller-Trumbore with the reference's sign flip
    (intersections.h:17-54) -> (hit, dist, bary [..., 2])."""
    from ..utils import math as mathx

    e01 = v1 - v0
    e02 = v2 - v0
    p = mathx.cross(d, e02)
    det = mathx.dot(p, e01)
    nondegenerate = torch.abs(det) >= torch.finfo(torch.float32).eps
    v0_to_o = o - v0
    flip = det < 0.0
    det = torch.abs(det)
    v0_to_o = torch.where(flip[..., None], -v0_to_o, v0_to_o)
    bx = mathx.dot(v0_to_o, p)
    perp = mathx.cross(v0_to_o, e01)
    by = mathx.dot(d, perp)
    inside = (bx >= 0.0) & (bx <= det) & (by >= 0.0) & (bx + by <= det)
    det_safe = torch.where(det > 0, det, 1.0)
    dist = mathx.dot(e02, perp) / det_safe
    bary = torch.stack([bx, by], dim=-1) / det_safe[..., None]
    return nondegenerate & inside & (dist > 0.0), dist, bary


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

