"""Camera, as `restir_tpu.ops.camera` (float32 leaves in the same order).

The camera lives on the host: it is a handful of scalars that change per
frame. `pack_camera` turns it into the [16] float32 vector the kernels
read (position, right, up, view, tan(fov_y), focal distance, 0, 0) and
places it on the device the frame runs on. `update_camera` and
`animate_position` move it on the host, as the CLI's animated camera
and the viewer do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    position: torch.Tensor  # [3]
    rotation: torch.Tensor  # [3] yaw/pitch/roll degrees
    view: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    fov_y: torch.Tensor  # scalar, degrees (used as the half angle)
    lens_radius: torch.Tensor  # scalar
    focal_dist: torch.Tensor  # scalar


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def derive_basis(rotation_deg):
    """view/right/up from yaw-pitch rotation (Camera::update)."""
    rot = torch.deg2rad(_f32(rotation_deg))
    yaw, pitch = rot[..., 0], rot[..., 1]
    view = torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
                        torch.sin(yaw) * torch.cos(pitch)], dim=-1)
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True)
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)
    right = torch.linalg.cross(view, world_up.expand_as(view))
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up = torch.linalg.cross(right, view)
    up = up / torch.linalg.norm(up, dim=-1, keepdim=True)
    return view, right, up


def make_camera(position, rotation=(0.0, 0.0, 0.0), fov_y=19.5,
                lens_radius=0.0, focal_dist=1.0) -> Camera:
    rotation = _f32(rotation)
    view, right, up = derive_basis(rotation)
    return Camera(position=_f32(position), rotation=rotation, view=view,
                  up=up, right=right, fov_y=_f32(fov_y),
                  lens_radius=_f32(lens_radius), focal_dist=_f32(focal_dist))


def update_camera(cam: Camera, position=None, rotation=None) -> Camera:
    """`cam` moved to `position` and / or turned to `rotation`, with its
    basis derived anew."""
    position = cam.position if position is None else _f32(position)
    rotation = cam.rotation if rotation is None else _f32(rotation)
    view, right, up = derive_basis(rotation)
    return cam._replace(position=position, rotation=rotation, view=view,
                        right=right, up=up)


def animate_position(base_position, t, radius):
    """Circular camera animation (main.cpp:149-153)."""
    t = _f32(t)
    return _f32(base_position) + torch.stack(
        [torch.cos(t), torch.zeros_like(t), torch.sin(t)], dim=-1) * radius


def as_numpy_camera(cam: Camera) -> Camera:
    return Camera(*(np.asarray(_f32(f).cpu()) for f in cam))


def pack_camera(cam: Camera, device=None) -> torch.Tensor:
    """Camera -> [16] float32 kernel vector on `device`."""
    tanf = torch.tan(torch.deg2rad(_f32(cam.fov_y)))
    zero = torch.zeros((), dtype=torch.float32)
    vec = torch.cat([
        _f32(cam.position), _f32(cam.right), _f32(cam.up), _f32(cam.view),
        torch.stack([tanf, _f32(cam.focal_dist), zero, zero]),
    ])
    return vec if device is None else vec.to(device)


def _on(x, device) -> torch.Tensor:
    return _f32(x).to(device)


def pixel_centers(width: int, height: int, device="cuda", pix0: int = 0,
                  r=None):
    """(x, y) integer pixel coordinates, row-major, flattened: of the
    whole frame [H*W], or of the r global pixels from pix0 (a row band's:
    whole rows)."""
    r = width * height - pix0 if r is None else r
    if pix0 % width or r % width:
        raise ValueError(f"pixel_centers takes whole rows of {width} "
                         f"pixels, got pixels {pix0} to {pix0 + r}")
    ys, xs = torch.meshgrid(
        torch.arange(pix0 // width, (pix0 + r) // width,
                     dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def sample_rays(cam: Camera, width: int, height: int, x, y, rx, ry,
                ra=None, rb=None):
    """Primary rays for pixels (x, y) with sub-pixel jitter (rx, ry) —
    Camera::sample (sceneStructs.h:69-86). With lens uniforms (ra, rb)
    and lens_radius > 0, the thin-lens model (camera.py:102-141).
    Returns (o [R, 3], d [R, 3])."""
    from ..utils import math as mathx

    dev = x.device
    pos, right, up, view = (_on(v, dev) for v in (
        cam.position, cam.right, cam.up, cam.view))
    focal = _on(cam.focal_dist, dev)
    aspect = width / height
    tan_fovy = torch.tan(torch.deg2rad(_on(cam.fov_y, dev)))
    ruv_x = 1.0 - 2.0 * (x + rx) / width
    ruv_y = 1.0 - 2.0 * (y + ry) / height
    fx = ruv_x * aspect * tan_fovy * focal
    fy = ruv_y * tan_fovy * focal
    fz = focal.expand(fx.shape)
    if ra is not None:
        p = mathx.to_concentric_disk(ra, rb) * _on(cam.lens_radius, dev)
        lx, ly = p[..., 0], p[..., 1]
    else:
        lx = torch.zeros_like(fx)
        ly = torch.zeros_like(fy)
    d = (right[None, :] * (fx - lx)[..., None]
         + up[None, :] * (fy - ly)[..., None]
         + view[None, :] * fz[..., None])
    d = d / mathx.norm(d)[..., None]
    o = (pos[None, :] + right[None, :] * lx[..., None]
         + up[None, :] * ly[..., None])
    return o.expand(d.shape), d


def raster_uv(cam: Camera, width: int, height: int, pos):
    """World pos -> this camera's raster uv in [0, 1]^2 —
    Camera::getRasterUV (sceneStructs.h:23-41)."""
    from ..utils import math as mathx

    dev = pos.device
    aspect = width / height
    tan_fovy = torch.tan(torch.deg2rad(_on(cam.fov_y, dev)))
    dirv = pos - _on(cam.position, dev)
    dirv = dirv / mathx.norm(dirv)[..., None]
    depth = mathx.dot(dirv, _on(cam.view, dev))
    inv_depth = 1.0 / depth
    px = mathx.dot(dirv, _on(cam.right, dev)) * inv_depth
    py = mathx.dot(dirv, _on(cam.up, dev)) * inv_depth
    ndc_x = -(px / (aspect * tan_fovy))
    ndc_y = -(py / tan_fovy)
    return ndc_x * 0.5 + 0.5, ndc_y * 0.5 + 0.5


def raster_coord(cam: Camera, width: int, height: int, pos):
    """Integer raster coordinates, truncated toward zero like the C
    float -> int cast — Camera::getRasterCoord (sceneStructs.h:43-46)."""
    from ..utils.math import trunc_i32

    u, v = raster_uv(cam, width, height, pos)
    return trunc_i32(u * width), trunc_i32(v * height)


def position_from_depth(cam: Camera, width: int, height: int, x, y, dist):
    """World position seen through pixel centre (x, y) at camera distance
    `dist` (Camera::getPosition, sceneStructs.h:48-64)."""
    o, d = sample_rays(cam, width, height, x, y, torch.full_like(x, 0.5),
                       torch.full_like(y, 0.5))
    return o + d * dist[..., None]
