"""Brute-force ray-triangle intersection over unit-triangle transforms,
as `restir_tpu.ops.intersect_bf` (the JAX package's CPU route).

Every triangle is pre-transformed (`scene_data.build_tri_transforms`)
into a unit-triangle space, so testing a chunk of rays against all
triangles is two products [Rb, 4] @ [4, 3N] followed by

    t = -oo.z / dd.z    u = oo.x + t dd.x    v = oo.y + t dd.y
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)

and an argmin over triangles (ties to the lowest index). These are the
plain versions of kernels B11 (`ops.kernels.intersect`): the products
run in float32, with TF32 off on the card (`matmul_f32`), and the
epilogues round as the jitted JAX functions do. A miss lane's
barycentrics are those of triangle 0, as in the JAX function; the
kernels write 0 there.
"""

from __future__ import annotations

import torch

from ..utils.math import fma, matmul_f32, norm

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5
OCCLUSION_EPS = 1e-4
CHUNK = 8192  # rays per product, as the JAX function


def _chunk_hits(xform, oc, dc):
    """One ray chunk: (dist [b], prim [b] i32, bary [b, 2])."""
    n = xform.shape[1] // 3
    ones = torch.ones_like(oc[:, :1])
    oo = matmul_f32(torch.cat([oc, ones], dim=1), xform).reshape(-1, n, 3)
    dd = matmul_f32(torch.cat([dc, ones * 0.0], dim=1),
                     xform).reshape(-1, n, 3)
    dz = dd[..., 2]
    nondeg = torch.abs(dz) >= 1e-12
    t = -oo[..., 2] / torch.where(nondeg, dz, 1.0)
    u = fma(t, dd[..., 0], oo[..., 0])  # rounded as the jitted JAX code
    v = fma(t, dd[..., 1], oo[..., 1])
    hit = nondeg & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    dist = torch.where(hit, t, torch.inf)
    best = torch.argmin(dist, dim=1)
    idx = best[:, None]
    best_dist = torch.gather(dist, 1, idx)[:, 0]
    bary = torch.stack([torch.gather(u, 1, idx)[:, 0],
                        torch.gather(v, 1, idx)[:, 0]], dim=-1)
    prim = torch.where(torch.isfinite(best_dist), best.to(torch.int32),
                       NULL_PRIMITIVE)
    return best_dist, prim, bary


def intersect_closest_bf(xform, o, d, active=None, chunk: int = CHUNK):
    """Closest hit over all triangles -> (prim [R] i32, dist [R],
    bary [R, 2]); inactive lanes get prim -1 and dist inf."""
    parts = [_chunk_hits(xform, o[i:i + chunk], d[i:i + chunk])
             for i in range(0, o.shape[0], chunk)]
    dist = torch.cat([p[0] for p in parts])
    prim = torch.cat([p[1] for p in parts])
    bary = torch.cat([p[2] for p in parts])
    if active is not None:
        dist = torch.where(active, dist, torch.inf)
        prim = torch.where(active, prim, NULL_PRIMITIVE)
    return prim, dist, bary


def occlusion_ray(x, y):
    """The shadow ray of the segment x -> y: (origin, direction, limit)
    with the reference's offsets (scene.h:286-316)."""
    seg = y - x
    dist = norm(seg)
    d = seg / torch.clamp(dist, min=1e-20)[..., None]
    return fma(d, RAY_OFFSET, x), d, dist - OCCLUSION_EPS * 2.0


def test_occlusion_bf(xform, x, y, active=None, chunk: int = CHUNK):
    """Any hit between x and y (bool [R]): a closest hit nearer than the
    segment's length less 2e-4."""
    o, d, limit = occlusion_ray(x, y)
    prim, dist, _ = intersect_closest_bf(xform, o, d, active=active,
                                         chunk=chunk)
    occluded = (prim != NULL_PRIMITIVE) & (dist < limit)
    if active is not None:
        occluded = occluded & active
    return occluded
