"""Surface interaction from a Hit, as `restir_tpu.ops.surface`
(DevScene::getIntersecGeomInfo, scene.h:135-151): barycentric
interpolation of position, normal and uv, and the material id."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import math as mathx
from .intersect import NULL_PRIMITIVE, Hit


class Interaction(NamedTuple):
    valid: torch.Tensor  # [R] bool: hit anything
    prim_id: torch.Tensor  # [R] int32
    mat_id: torch.Tensor  # [R] int32
    pos: torch.Tensor  # [R, 3]
    norm: torch.Tensor  # [R, 3]
    uv: torch.Tensor  # [R, 2]


def make_interaction(scene, hit: Hit) -> Interaction:
    prim = torch.clamp(hit.prim_id, min=0).long()
    tri_v = scene.verts[prim]  # [R, 3, 3]
    tri_n = scene.norms[prim]
    tri_t = scene.uvs[prim]
    bx = hit.bary[..., 0:1]
    by = hit.bary[..., 1:2]
    w0 = 1.0 - bx - by

    def interp(t):
        return mathx.weighted3(t[..., 1, :], bx, t[..., 2, :], by,
                               t[..., 0, :], w0)

    pos = interp(tri_v)
    norm = mathx.safe_normalize(interp(tri_n))
    uv = interp(tri_t)
    return Interaction(valid=hit.prim_id != NULL_PRIMITIVE,
                       prim_id=hit.prim_id, mat_id=scene.mat_ids[prim],
                       pos=pos, norm=norm, uv=uv)


def prim_area(scene, prim_id):
    """DevScene::getPrimitiveArea (scene.h:121-126)."""
    tri = scene.verts[torch.clamp(prim_id, min=0).long()]
    return mathx.triangle_area(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
