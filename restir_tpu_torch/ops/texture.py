"""Texture fetch, as `restir_tpu.ops.texture`: wrap-mode bilinear
sampling of the packed texel array (image.h:41-74), the equirect env
map, the hash-jittered procedural texture (scene.h:68-76) and the
textured material with normal mapping (scene.h:78-99)."""

from __future__ import annotations

import torch

from ..scene.mesh import NULL_TEXTURE, PROCEDURAL_TEXTURE
from ..utils import math as mathx
from ..utils import rng


def _fract(x):
    return x - torch.floor(x)


def bilinear_sample(data, offset, width, height, uv):
    """data [K, 3]; offset / width / height [R] int32 per lane; uv [R, 2]
    -> [R, 3]."""
    u = _fract(uv[..., 0])
    v = _fract(uv[..., 1])
    fx = mathx.muladd(u, width.to(torch.float32), -0.5)
    fy = mathx.muladd(v, height.to(torch.float32), -0.5)
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    lx = fx - ix
    ly = fy - iy
    x0 = torch.remainder(mathx.trunc_i32(ix), width)
    y0 = torch.remainder(mathx.trunc_i32(iy), height)
    x1 = torch.remainder(x0 + 1, width)
    y1 = torch.remainder(y0 + 1, height)

    def fetch(x, y):
        return data[(offset + y * width + x).long()]

    cx0 = mathx.mix(fetch(x0, y0), fetch(x1, y0), lx[..., None])
    cx1 = mathx.mix(fetch(x0, y1), fetch(x1, y1), lx[..., None])
    return mathx.mix(cx0, cx1, ly[..., None])


def env_sample_bilinear(env_map, uv):
    """Bilinear sample of the [Eh, Ew, 3] equirect env map at uv."""
    eh, ew = env_map.shape[0], env_map.shape[1]
    shape = uv.shape[:-1]
    dev = uv.device
    return bilinear_sample(
        env_map.reshape(-1, 3), torch.zeros(shape, dtype=torch.int32,
                                            device=dev),
        torch.full(shape, ew, dtype=torch.int32, device=dev),
        torch.full(shape, eh, dtype=torch.int32, device=dev), uv)


def procedural_texture(uv):
    """Sine-grid procedural texture with a pcg4d jitter per 1/1024 cell.
    The cell index wraps as int32 arithmetic does."""
    cell = (mathx.trunc_i32(uv[..., 0] * 1024).to(torch.int64) * 1024
            + mathx.trunc_i32(uv[..., 1] * 1024).to(torch.int64))
    rx, ry, _, _ = rng.uniform4(cell, 0, 0, rng.SALT_DEBUG)
    f = (torch.sin(mathx.muladd(uv[..., 0] * 10.0, mathx.TWO_PI,
                                rx * mathx.TWO_PI)) + 1.0) * 0.5
    g = (torch.sin(mathx.muladd(uv[..., 1] * 10.0, mathx.TWO_PI,
                                ry * mathx.TWO_PI)) + 1.0) * 0.5
    return (f * g)[..., None].expand(*f.shape, 3)


def apply_texture_maps(scene, base_map, metallic_map, roughness_map,
                       normal_map, uv, norm, base_color, metallic,
                       roughness):
    """The texture maps of a textured frame: base colour, metallic,
    roughness and the tangent-space normal map. Returns (base_color,
    metallic, roughness, shading normal)."""

    def tex(map_id, fallback):
        tid = torch.clamp(map_id, min=0).long()
        sampled = bilinear_sample(scene.tex_data, scene.tex_offset[tid],
                                  scene.tex_width[tid],
                                  scene.tex_height[tid], uv)
        return torch.where((map_id > NULL_TEXTURE)[..., None], sampled,
                           fallback)

    base_color = tex(base_map, base_color)
    metallic = tex(metallic_map, metallic[..., None].expand(
        *metallic.shape, 3))[..., 0]
    roughness = tex(roughness_map, roughness[..., None].expand(
        *roughness.shape, 3))[..., 0]
    mapped = tex(normal_map, torch.zeros_like(base_color))
    remapped = mathx.local_to_world(norm, mathx.safe_normalize(mapped - 0.5))
    norm = torch.where((normal_map > NULL_TEXTURE)[..., None], remapped, norm)
    return base_color, metallic, roughness, norm


def fetch_textured_material(scene, mat_id, uv, norm, with_textures: bool):
    """Material parameters with texture maps and normal mapping ->
    (SurfaceMaterial, shading normal). Without `with_textures` only the
    procedural base colour is kept."""
    from .bsdf import SurfaceMaterial

    mat_id = torch.clamp(mat_id, min=0).long()
    base_color = scene.mat_base_color[mat_id]
    metallic = scene.mat_metallic[mat_id]
    roughness = scene.mat_roughness[mat_id]
    base_map = scene.mat_base_map[mat_id]
    base_color = torch.where((base_map == PROCEDURAL_TEXTURE)[..., None],
                             procedural_texture(uv), base_color)
    if with_textures:
        base_color, metallic, roughness, norm = apply_texture_maps(
            scene, base_map, scene.mat_metallic_map[mat_id],
            scene.mat_roughness_map[mat_id], scene.mat_normal_map[mat_id],
            uv, norm, base_color, metallic, roughness)
    return SurfaceMaterial(type=scene.mat_type[mat_id], base_color=base_color,
                           metallic=metallic, roughness=roughness,
                           ior=scene.mat_ior[mat_id]), norm
