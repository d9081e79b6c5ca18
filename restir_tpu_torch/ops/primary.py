"""Primary-hit assembly, as `restir_tpu.ops.primary`: closest hit,
interaction and textured material of a ray batch, for the G-buffer and
every bounce.

On CUDA tensors it runs kernel B12, or B13's primary build when the
intersector is the MTBVH walk (`ops.kernels.intersect.primary_hit`:
closest hit, attribute interpolation and material row in one launch),
then the procedural, texture and normal-map branches as tensor ops, as
the JAX function does after its Pallas kernel (primary.py:34-90). On CPU
tensors, or with `plain` (the kernel twins on the card), it composes the
plain closest hit of the method (`intersect_bf`'s brute force or the
walk's twin), `make_interaction` and `fetch_textured_material`
(primary.py:92-98), the JAX package's CPU route.
"""

from __future__ import annotations

import torch

from ..scene.mesh import PROCEDURAL_TEXTURE
from . import intersect as ix
from . import surface as surf
from .bsdf import SurfaceMaterial
from .kernels import intersect as kernels
from .texture import (
    apply_texture_maps,
    fetch_textured_material,
    procedural_texture,
)


def trace_primary(scene, trv: ix.TraversalArrays, o, d, with_textures: bool,
                  active=None, plain: bool = False, geom=None):
    """-> (Interaction, SurfaceMaterial, Hit). With `active`, inactive
    lanes miss: the kernel does not walk them and writes its miss pack,
    the plain route masks their primitive and distance. `geom` (width,
    pix0): the batch holds one ray per pixel from global pixel pix0 of a
    frame `width` wide (B13's launch; the plain route ignores it)."""
    if plain or not o.is_cuda:
        hit = ix.Hit(*kernels.closest_plain(trv, o, d, active))
        it = surf.make_interaction(scene, hit)
        mat, mapped = fetch_textured_material(scene, it.mat_id, it.uv,
                                              it.norm, with_textures)
        return it._replace(norm=mapped), mat, hit

    prim, dist, bary, pos, norm, uv, matp = kernels.primary_hit(
        trv, scene.prim_attr, scene.mat_attr, o, d, active, geom)
    base_color = matp[:, 1:4]
    base_map = matp[:, 7].to(torch.int32)
    base_color = torch.where((base_map == PROCEDURAL_TEXTURE)[..., None],
                             procedural_texture(uv), base_color)
    metallic, roughness = matp[:, 4], matp[:, 5]
    if with_textures:
        base_color, metallic, roughness, norm = apply_texture_maps(
            scene, base_map, matp[:, 8].to(torch.int32),
            matp[:, 9].to(torch.int32), matp[:, 10].to(torch.int32), uv,
            norm, base_color, metallic, roughness)
    it = surf.Interaction(valid=prim != ix.NULL_PRIMITIVE, prim_id=prim,
                          mat_id=matp[:, 11].to(torch.int32), pos=pos,
                          norm=norm, uv=uv)
    mat = SurfaceMaterial(type=matp[:, 0].to(torch.int32),
                          base_color=base_color, metallic=metallic,
                          roughness=roughness, ior=matp[:, 6])
    return it, mat, ix.Hit(prim_id=prim, dist=dist, bary=bary)
