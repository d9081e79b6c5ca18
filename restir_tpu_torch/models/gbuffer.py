"""G-buffer pass of the general path, as `restir_tpu.models.gbuffer`
(gbuffer.cu:3-86): the primary hit's attributes and motion vectors.

The pass returns the full interaction and textured material too, so the
integrators reuse the primary hit. `prim_id` holds the material id, with
light hits remapped to LIGHT_ID and misses to NULL_PRIMITIVE
(gbuffer.cu:28-42), for the temporal / spatial similarity tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..ops import intersect as ix
from ..ops.camera import Camera, pixel_centers, raster_coord, sample_rays
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.mesh import LIGHT
from ..utils import math as mathx
from ..utils import rng

NULL_PRIMITIVE = ix.NULL_PRIMITIVE  # -1
LIGHT_ID = NULL_PRIMITIVE - 1  # gbuffer.cu:31


class GBufferFrame(NamedTuple):
    albedo: torch.Tensor  # [R, 3] demodulation albedo (env radiance on miss)
    norm: torch.Tensor  # [R, 3]
    prim_id: torch.Tensor  # [R] int32: matId | LIGHT_ID | NULL_PRIMITIVE
    depth: torch.Tensor  # [R] camera distance (1 on miss)
    pos: torch.Tensor  # [R, 3] world position (0 on miss)
    motion: torch.Tensor  # [R] int32 last-frame pixel index (-1 invalid)


def empty_gbuffer(num_pixels: int, device="cuda") -> GBufferFrame:
    """First-frame history: every temporal lookup is rejected."""
    r = num_pixels

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return GBufferFrame(
        albedo=z(r, 3), norm=z(r, 3),
        prim_id=torch.full((r,), NULL_PRIMITIVE, dtype=torch.int32,
                           device=device),
        depth=torch.ones((r,), dtype=torch.float32, device=device),
        pos=z(r, 3),
        motion=torch.full((r,), -1, dtype=torch.int32, device=device))


def band_size(cfg: RenderConfig, pix0: int, r) -> int:
    """The pixel count of the band from global pixel pix0 (`r`, or the
    rest of the frame)."""
    return cfg.num_pixels - pix0 if r is None else r


def primary_rays(cam: Camera, cfg: RenderConfig, looper, salt, device,
                 sampler="pcg4d", pix0: int = 0, r=None):
    """Camera rays with the frame's jitter draws (and lens draws with
    DoF) -> (pix, o, d): of every pixel, or of the r pixels from global
    pixel pix0, each keyed by its global index."""
    r = band_size(cfg, pix0, r)
    x, y = pixel_centers(cfg.width, cfg.height, device, pix0, r)
    pix = torch.arange(pix0, pix0 + r, device=device)
    r1, r2, r3, r4 = rng.draw4(sampler, pix, looper, 0, salt)
    lens = (r3, r4) if cfg.enable_dof else (None, None)
    o, d = sample_rays(cam, cfg.width, cfg.height, x, y, r1, r2, *lens)
    return pix, o, d


def render_gbuffer(scene, cam: Camera, last_cam: Camera, cfg: RenderConfig,
                   looper, pix0: int = 0, r=None):
    """One primary-visibility pass -> (GBufferFrame, Interaction,
    SurfaceMaterial, ray_dir [R, 3]): of the frame, or of the row band of
    r pixels from global pixel pix0. The motion index is global."""
    dev = scene.verts.device
    trv = ix.traversal_arrays(scene, cfg.intersector)
    if cfg.aa_jitter:
        _, o, d = primary_rays(cam, cfg, looper, rng.SALT_CAMERA, dev,
                               pix0=pix0, r=r)
    else:
        x, y = pixel_centers(cfg.width, cfg.height, dev, pix0,
                             band_size(cfg, pix0, r))
        half = torch.full_like(x, 0.5)
        lens = (half, half) if cfg.enable_dof else (None, None)
        o, d = sample_rays(cam, cfg.width, cfg.height, x, y, half, half,
                           *lens)

    it, mat, _ = trace_primary(scene, trv, o, d, cfg.with_textures,
                               geom=(cfg.width, pix0))
    is_light = it.valid & (mat.type == LIGHT)
    front = mathx.dot(it.norm, d) < 0.0
    # single-sided back-face light hits become misses (gbuffer.cu:32-36)
    valid = (it.valid & ~(is_light & ~front) if cfg.single_sided_lights
             else it.valid)
    it = it._replace(valid=valid)
    prim_id = torch.where(valid, torch.where(is_light, LIGHT_ID, it.mat_id),
                          NULL_PRIMITIVE).to(torch.int32)
    if cfg.has_env_map:
        miss_albedo = env_sample_bilinear(scene.env_map, mathx.to_plane(d))
    else:
        miss_albedo = torch.zeros_like(mat.base_color)
    v3 = valid[..., None]
    albedo = torch.where(v3, mat.base_color, miss_albedo)
    norm = torch.where(v3, it.norm, 0.0)
    depth = torch.where(valid, mathx.length(it.pos - o), 1.0)
    pos = torch.where(v3, it.pos, 0.0)
    # motion: the last-frame linear index by reprojection (gbuffer.cu:49-55);
    # miss pixels store 0 like the reference (:71)
    lx, ly = raster_coord(last_cam, cfg.width, cfg.height, it.pos)
    in_bounds = (lx >= 0) & (lx < cfg.width) & (ly >= 0) & (ly < cfg.height)
    motion = torch.where(valid, torch.where(in_bounds, ly * cfg.width + lx,
                                            -1), 0).to(torch.int32)
    gb = GBufferFrame(albedo=albedo, norm=norm, prim_id=prim_id, depth=depth,
                      pos=pos, motion=motion)
    return gb, it, mat, d
