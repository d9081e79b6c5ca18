"""Kernel B6: the G-buffer pack through an MTBVH closest-hit walk, and its
plain PyTorch twin.

Port of `restir_tpu.ops.pallas.fused_di.gbuffer_pack_pallas` (its kernels
`_gbuffer_kernel_sub`, `_gbuffer_kernel` and `_gbuffer_kernel_resident`):
per pixel, raygen with AA jitter, the closest hit, and the G-buffer
epilogue with motion reprojection. Returns gb [GB_CH, R] in linear pixel
order.

`gbuffer_pack` dispatches on the device of its tensors: CPU tensors take
the twin `gbuffer_ref` (B1's brute-force stage, `fused_di.gbuffer_pixels`,
whose hits the walk reproduces), CUDA tensors the kernel in
`csrc/gbuffer_bvh.cu`. Nothing falls back. `has_env` / `with_textures`
select the epilogue's env and texture branches, as in B1.

A row band (`restir_tpu_torch.parallel`) passes its first global pixel
`pix0` and its pixel count `r`: the pack then holds pixels [pix0, pix0 +
r) of the frame, whose rays, jitter draws, raster coordinates and motion
are the whole frame's (the JAX `gbuffer_pack_pallas(pix0=, xy=)`). A
band need not hold whole rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, fused_di
from .fused_di import GB_CH, _check, band_pixels
from .tables import BvhTables

launches = 0  # gbuffer_bvh kernel launches

# 2-D pixel tiles of B6 and B7 (csrc/common.cuh, tile_pixel): a block of
# BLOCK threads covers BLOCK_W x BLOCK_H pixels, each warp WARP_W x WARP_H.
BLOCK = 256
BLOCK_W, BLOCK_H = 32, 8
WARP_W, WARP_H = 8, 4


def tile_order(width, height, device=None, pix0=0, r=None):
    """Global pixel index of every thread of a tiled launch over a width x
    height frame, or over the band of `r` pixels from `pix0` (the rows it
    touches), in launch order (block rows, blocks, threads), -1 where a
    thread falls off the ragged edge or outside the band: the map of
    csrc/common.cuh's `tile_pixel`."""
    if r is None:
        r = width * height - pix0
    y0 = pix0 // width
    rows = (pix0 + r - 1) // width - y0 + 1
    gx = -(-width // BLOCK_W)
    gy = -(-rows // BLOCK_H)
    t = torch.arange(BLOCK, device=device)
    warp, lane = t // 32, t % 32
    wx = (warp % (BLOCK_W // WARP_W)) * WARP_W + lane % WARP_W
    wy = (warp // (BLOCK_W // WARP_W)) * WARP_H + lane // WARP_W
    by = torch.arange(gy, device=device)[:, None, None]
    bx = torch.arange(gx, device=device)[None, :, None]
    x = bx * BLOCK_W + wx[None, None, :]
    y = y0 + by * BLOCK_H + wy[None, None, :]
    g = y * width + x
    p = torch.where((x < width) & (g >= pix0) & (g < pix0 + r), g, -1)
    return p.reshape(-1)


def gbuffer_ref(cam_vec, lcam_vec, looper, bvh: BvhTables, *, width, height,
                aa_jitter=True, single_sided=True, has_env=False,
                with_textures=False, pix=None, pix0=0, r=None):
    """Plain twin: gb columns of pixels `pix` (int64 global indices; when
    None, the band of `r` pixels from `pix0`, by default the whole frame),
    by brute force over all triangles."""
    fused_di.check_env(bvh.env_rad, has_env)
    dev = cam_vec.device
    if pix is None:
        pix0, r = band_pixels(width, height, pix0, r)
        pix = torch.arange(pix0, pix0 + r, device=dev, dtype=torch.int64)
    out = torch.empty((GB_CH, pix.shape[0]), dtype=torch.float32,
                      device=dev)
    chunk = fused_di.chunk_pixels(bvh.planes.shape[0])
    for p0 in range(0, pix.shape[0], chunk):
        out[:, p0:p0 + chunk] = fused_di.gbuffer_pixels(
            pix[p0:p0 + chunk], cam_vec, lcam_vec, looper, bvh, width=width,
            height=height, aa_jitter=aa_jitter, single_sided=single_sided,
            has_env=has_env, with_textures=with_textures)
    return out


def _check_bvh(bvh: BvhTables, dev):
    for name in ("planes", "attr", "mat", "env_rad", "atlas", "tex_meta"):
        t = getattr(bvh, name)
        _check(t, name, t.shape, dev)
    _check(bvh.rows, "rows", (6 * bvh.size, 8), dev)


def gbuffer_cuda(cam_vec, lcam_vec, looper, bvh: BvhTables, *, width,
                 height, aa_jitter=True, single_sided=True, has_env=False,
                 with_textures=False, stats=False, pix0=0, r=None,
                 lib=None):
    """Launch `csrc/gbuffer_bvh.cu` over the band of `r` pixels from
    `pix0` (by default the whole frame). With `stats`, also return the
    int32 [2, r] box and triangle test counts of each ray. `lib`: a
    library of a stage probe's build (`_build.variant_library`) in place
    of the main one."""
    global launches
    pix0, r = band_pixels(width, height, pix0, r)
    dev = cam_vec.device
    _check(cam_vec, "cam_vec", (16,), dev)
    _check(lcam_vec, "lcam_vec", (16,), dev)
    _check_bvh(bvh, dev)
    fused_di.check_env(bvh.env_rad, has_env)
    gb = torch.empty((GB_CH, r), dtype=torch.float32, device=dev)
    counts = (torch.empty((2, r), dtype=torch.int32, device=dev)
              if stats else None)
    p = _build.ptr
    lib = lib or _build.library()
    with _build.on_device(dev):
        err = lib.restir_gbuffer_bvh(
            p(cam_vec), p(lcam_vec), ctypes.c_uint32(looper & 0xFFFFFFFF),
            p(bvh.rows), bvh.size, p(bvh.planes), p(bvh.attr),
            p(bvh.mat), bvh.mat.shape[0], p(bvh.env_rad), p(bvh.atlas),
            p(bvh.tex_meta), bvh.tex_meta.shape[0], int(has_env),
            int(with_textures), p(gb), p(counts), width, height, pix0, r,
            ctypes.c_float(float(width) / float(height)), int(aa_jitter),
            int(single_sided), _build.stream_of(dev))
    _build.check(err, "restir_gbuffer_bvh")
    launches += 1
    return (gb, counts) if stats else gb


def gbuffer_pack(cam_vec, lcam_vec, looper, bvh: BvhTables, *, width,
                 height, aa_jitter=True, single_sided=True, has_env=False,
                 with_textures=False, pix0=0, r=None):
    """gb [GB_CH, r] for the band of `r` pixels from `pix0` of one frame
    (by default the whole frame: [GB_CH, R]): the twin on CPU tensors,
    the kernel on CUDA tensors."""
    kw = dict(width=width, height=height, aa_jitter=aa_jitter,
              single_sided=single_sided, has_env=has_env,
              with_textures=with_textures, pix0=pix0, r=r)
    if cam_vec.device.type == "cpu":
        return gbuffer_ref(cam_vec, lcam_vec, looper, bvh, **kw)
    if cam_vec.device.type == "cuda":
        return gbuffer_cuda(cam_vec, lcam_vec, looper, bvh, **kw)
    raise ValueError(f"unsupported device {cam_vec.device}")
