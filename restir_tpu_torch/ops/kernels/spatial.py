"""Kernel B2: spatial merge + shade + running mean, and its plain twin.

Port of `restir_tpu.ops.pallas.fused_di._spatial_kernel`
(`spatial_shade_pallas`). Neighbour offsets are drawn per (1024-pixel
tile, neighbour, frame) by `spatial_offsets`, torch glue that mirrors
the JAX wrapper's (`offs` [T, N, 5] int32: aligned start, dx, dy, lane
residue, valid); the kernel and the twin take the table as an input,
so the glue and the kernel are tested apart. Per pixel, neighbour i is
read where the TPU kernel's window lands it (start + residue + the
pixel's lane in its tile: p + dy*W + dx unless the start was clamped)
and rejected out of frame, on a primitive mismatch, when n.n' < 0.9, on
depth beyond 10% or on a bad weight.

A row band (`restir_tpu_torch.parallel`) passes its first global pixel
`pix0`, the pt pack with +-`halo` pixels from its neighbours (`pt_ext`)
and the frame's pixel count `r_total`, as the JAX
`spatial_shade_pallas(pix0=, halo=, r_total=)`: offsets are drawn per
global tile and judged on the whole frame's pixels, and the draws key on
the global pixel.

`spatial_shade` updates `accum` IN PLACE (each pixel reads and writes
only its own three accumulator values) and returns it.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import rng
from . import _build
from .fused_di import (
    CTR_SPATIAL,
    DIELECTRIC,
    G_ALB,
    G_DEPTH,
    G_DIR,
    G_LIGHT,
    G_METAL,
    G_MISS,
    G_MTYPE,
    G_NORM,
    G_PRIMR,
    G_ROUGH,
    G_SHADE,
    G_X,
    G_Y,
    GB_CH,
    P_DEPTH,
    P_LI,
    P_M,
    P_NORM,
    P_PRIMR,
    P_WEIGHT,
    P_WI,
    PT_CH,
    TILE,
    _bad,
    _check,
    band_pixels,
    eval_bsdf_lum,
)

launches = 0  # CUDA kernel launches

_CHUNK = 65536


def spatial_offsets(looper: int, r: int, width: int, neighbors: int,
                    radius: float, device, *, pix0: int = 0, halo: int = 0,
                    r_total=None) -> torch.Tensor:
    """[T, N, 5] int32 per-(tile, neighbour, frame) offset table of the
    `r` pixels from global pixel `pix0`, as the `offs` of
    `spatial_shade_pallas`: (128-aligned read start in the pt pack with
    +-`halo` pixels, dx, dy, lane residue, valid). Validity is judged on
    the frame's global pixels (`r_total`, by default the haloed pack's
    r + 2 halo: one device's whole frame)."""
    n_tiles = r // TILE
    r_ext = r + 2 * halo
    if r_total is None:
        r_total = r_ext
    tiles = (pix0 // TILE
             + torch.arange(n_tiles, device=device, dtype=torch.int64))
    local = torch.arange(n_tiles, device=device, dtype=torch.int32) * TILE
    cols = []
    for i in range(neighbors):
        s1, s2, _, _ = rng.uniform4(tiles, looper, CTR_SPATIAL + i,
                                    rng.SALT_RESTIR)
        rr = torch.sqrt(s1) * radius
        theta = s2 * (2.0 * 3.14159265358979)
        dx = (0.5 + rr * torch.cos(theta)).to(torch.int32)
        dy = (0.5 + rr * torch.sin(theta)).to(torch.int32)
        off = dy * width + dx
        start_g = pix0 + local + off
        start_ga = torch.div(start_g, 128, rounding_mode="floor") * 128
        valid = ((start_ga >= 0) & (start_ga <= r_total - TILE - 128)
                 & ~((dx == 0) & (dy == 0)))
        start0 = local + off + halo
        start_a = torch.div(start0, 128, rounding_mode="floor") * 128
        delta = start0 - start_a
        start_a = torch.clamp(start_a, 0, r_ext - TILE - 128)
        cols.append(torch.stack(
            [start_a, dx, dy, delta, valid.to(torch.int32)], -1))
    return torch.stack(cols, dim=1).to(torch.int32).contiguous()


def _spatial_chunk(offs, gb, pt, pt_ext, pix, looper, *, width, height,
                   neighbors, reuse_spatial, pix0=0):
    """(li [3, b], wi [3, b], weight, m) after the spatial merge (the
    merged sample's distance is not needed for shading) for the band's
    pixels `pix` (local indices; neighbours from `pt_ext`)."""
    g = gb[:, pix]
    s = pt[:, pix]
    li, wi = s[P_LI:P_LI + 3], s[P_WI:P_WI + 3]
    r_weight, r_m = s[P_WEIGHT], s[P_M]
    if not reuse_spatial:
        return li, wi, r_weight, r_m
    x, y = g[G_X], g[G_Y]
    depth, prim_remap = g[G_DEPTH], g[G_PRIMR]
    shade = g[G_SHADE] > 0.5
    tile = torch.div(pix, TILE, rounding_mode="floor")
    lane = pix - tile * TILE
    r_ext = pt_ext.shape[1]
    w_list, ok_list, nb_list = [], [], []
    for i in range(neighbors):
        o = offs[tile, i].to(torch.int64)  # [b, 5]
        dx, dy, usable = o[:, 1], o[:, 2], o[:, 4] > 0
        npx = x + dx.to(torch.float32)
        npy = y + dy.to(torch.float32)
        ok = (usable & (npx >= 0.0) & (npx < float(width))
              & (npy >= 0.0) & (npy < float(height)))
        q = torch.where(ok, o[:, 0] + o[:, 3] + lane, 0).clamp(0, r_ext - 1)
        nb = pt_ext[:, q]
        n_weight = nb[P_WEIGHT]
        ok = ok & (nb[P_PRIMR] == prim_remap)
        ok = ok & ((g[G_NORM] * nb[P_NORM] + g[G_NORM + 1] * nb[P_NORM + 1]
                    + g[G_NORM + 2] * nb[P_NORM + 2]) >= 0.9)
        ok = ok & (torch.abs(depth - nb[P_DEPTH]) <= depth * 0.1)
        ok = ok & ~_bad(n_weight)
        w_list.append(torch.where(ok, n_weight, 0.0))
        ok_list.append(ok)
        nb_list.append(nb)

    c = w_list[0]
    cums = []
    for j in range(1, neighbors):
        cums.append(c)
        c = c + w_list[j]
    a_weight = c
    a_m = torch.where(ok_list[0], nb_list[0][P_M], 0.0)
    for j in range(1, neighbors):
        a_m = a_m + torch.where(ok_list[j], nb_list[j][P_M], 0.0)

    pg = pix + pix0  # the global pixel
    u_sel = rng.uniform1(pg, looper, CTR_SPATIAL, rng.SALT_RESTIR)
    r_s = rng.uniform1(pg, looper, CTR_SPATIAL + neighbors, rng.SALT_RESTIR)
    thresh = u_sel * a_weight
    jsel = torch.zeros_like(pix)
    for cj in cums:
        jsel = jsel + (cj <= thresh).to(torch.int64)
    stack_nb = torch.stack(nb_list)  # [N, PT_CH, b]
    stack_ok = torch.stack(ok_list)  # [N, b]
    win = torch.gather(stack_nb, 0,
                       jsel[None, None, :].expand(1, PT_CH, -1))[0]
    win_ok = torch.gather(stack_ok, 0, jsel[None, :])[0]
    take_w = (a_weight > 0.0) & win_ok
    a_li = torch.where(take_w[None], win[P_LI:P_LI + 3], 0.0)
    a_wi = torch.where(take_w[None], win[P_WI:P_WI + 3], 0.0)

    ok = ~_bad(a_weight) & ~_bad(r_weight) & shade
    w_new = torch.where(ok, r_weight + a_weight, r_weight)
    m_new = torch.where(ok, r_m + a_m, r_m)
    take = ok & (r_s * w_new < a_weight)
    li = torch.where(take[None], a_li, li)
    wi = torch.where(take[None], a_wi, wi)
    return li, wi, w_new, m_new


def spatial_shade_ref(offs, gb, pt, accum, looper, iteration, *, width,
                      height, neighbors=5, accumulate=True,
                      reuse_spatial=True, has_met=True, pt_ext=None, pix0=0):
    """Plain PyTorch twin of the spatial kernel (updates accum in place)
    on gb's r pixels from global pixel `pix0` (the whole frame by
    default); `pt_ext` (pt itself by default) holds the neighbours."""
    r = gb.shape[1]
    dev = gb.device
    if pt_ext is None:
        pt_ext = pt
    it = float(iteration)
    for p0 in range(0, r, _CHUNK):
        pix = torch.arange(p0, min(p0 + _CHUNK, r), device=dev,
                           dtype=torch.int64)
        li, wi, r_weight, r_m = _spatial_chunk(
            offs, gb, pt, pt_ext, pix, looper, width=width, height=height,
            neighbors=neighbors, reuse_spatial=reuse_spatial, pix0=pix0)
        g = gb[:, pix]
        mtype, metallic, roughness = g[G_MTYPE], g[G_METAL], g[G_ROUGH]
        wo = (-g[G_DIR], -g[G_DIR + 1], -g[G_DIR + 2])
        gn = (g[G_NORM], g[G_NORM + 1], g[G_NORM + 2])
        ndotwo = gn[0] * wo[0] + gn[1] * wo[1] + gn[2] * wo[2]
        flip = (mtype != DIELECTRIC) & (ndotwo < 0.0)
        sgn = torch.where(flip, -1.0, 1.0)
        sn = (gn[0] * sgn, gn[1] * sgn, gn[2] * sgn)
        f_lum = eval_bsdf_lum(mtype, metallic, roughness, sn, wo,
                              (wi[0], wi[1], wi[2]), has_met)
        li_lum = 0.2126 * li[0] + 0.7152 * li[1] + 0.0722 * li[2]
        shade = g[G_SHADE] > 0.5
        w_big = r_weight / torch.clamp(r_m, min=1.0)
        scale = w_big / torch.clamp(li_lum, min=1e-20)
        live = shade & ~_bad(r_weight) & (f_lum > 0.0) & (li_lum > 0.0)
        scale = torch.where(live, scale, 0.0)
        out = li * scale[None]
        out = torch.where(torch.isnan(out) | torch.isinf(out), 0.0, out)
        one = (g[G_LIGHT] > 0.5) | (g[G_MISS] > 0.5)
        out = torch.where(one[None], 1.0, out)
        out = out * g[G_ALB:G_ALB + 3]
        if accumulate:
            inv = 1.0 / (it + 1.0)
            out = (accum[:, pix] * it + out) * inv
        accum[:, pix] = out
    return accum


def spatial_shade_cuda(offs, gb, pt, accum, looper, iteration, *, width,
                       height, neighbors=5, accumulate=True,
                       reuse_spatial=True, has_met=True, pt_ext=None, pix0=0):
    """Launch the B2 kernel of `csrc/spatial.cu` (accum in place) on gb's
    r pixels from global pixel `pix0` (the whole frame by default);
    `pt_ext` (pt itself by default) holds the neighbours."""
    global launches
    r = gb.shape[1]
    dev = gb.device
    if r % TILE != 0:
        raise ValueError(f"pixel count {r} is not a multiple of {TILE}")
    band_pixels(width, height, pix0, r)
    if pt_ext is None:
        pt_ext = pt
    if pt_ext.shape[1] < r:
        raise ValueError(f"pt_ext has {pt_ext.shape[1]} pixels, fewer than "
                         f"the band's {r}")
    _check(gb, "gb", (GB_CH, r), dev)
    _check(pt, "pt", (PT_CH, r), dev)
    _check(pt_ext, "pt_ext", (PT_CH, pt_ext.shape[1]), dev)
    _check(accum, "accum", (3, r), dev)
    if (offs.device != dev or offs.dtype != torch.int32
            or tuple(offs.shape) != (r // TILE, neighbors, 5)
            or not offs.is_contiguous()):
        raise ValueError("offs must be contiguous int32 [T, N, 5] on "
                         f"{dev}, got {offs.dtype} {tuple(offs.shape)}")
    lib = _build.library()
    p = _build.ptr
    with _build.on_device(dev):
        err = lib.restir_spatial_shade(
            p(offs), p(gb), p(pt), p(pt_ext), p(accum), r, pt_ext.shape[1],
            width, height, pix0, ctypes.c_uint32(looper & 0xFFFFFFFF),
            int(iteration), neighbors,
            int(reuse_spatial) | (int(accumulate) << 1) | (int(has_met) << 2),
            _build.stream_of(dev))
    _build.check(err, "restir_spatial_shade")
    launches += 1
    return accum


def spatial_shade(offs, gb, pt, accum, looper, iteration, *, width, height,
                  neighbors=5, accumulate=True, reuse_spatial=True,
                  has_met=True, pt_ext=None, pix0=0):
    """Spatial merge + shade + running mean into `accum` [3, r] (in
    place) for gb's r pixels from global pixel `pix0` (the whole frame by
    default), neighbours read from `pt_ext` (pt itself by default). CPU
    tensors take the plain twin, CUDA tensors the kernel."""
    kw = dict(width=width, height=height, neighbors=neighbors,
              accumulate=accumulate, reuse_spatial=reuse_spatial,
              has_met=has_met, pt_ext=pt_ext, pix0=pix0)
    if gb.device.type == "cpu":
        return spatial_shade_ref(offs, gb, pt, accum, looper, iteration, **kw)
    if gb.device.type == "cuda":
        return spatial_shade_cuda(offs, gb, pt, accum, looper, iteration,
                                  **kw)
    raise ValueError(f"unsupported device {gb.device}")
