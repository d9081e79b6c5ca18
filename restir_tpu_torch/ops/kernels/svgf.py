"""Kernel B5 (SVGF temporal accumulation) and the SVGF variance passes,
with their plain PyTorch twins.

`svgf_temporal` ports `restir_tpu.ops.pallas.fused_di._svgf_temporal_kernel`
(`svgf_temporal_pallas`; temporalAccumulate, denoiser.cu:250-305): per
pixel, the previous svgf pack's column at the motion index (inside the
tile's 2048-pixel window), the disocclusion reset (window miss, NULL
prim, prim mismatch, |n.n'| < 0.1) and the alpha = 0.2 blend of colour
and of the (lum, lum^2) moments. `estimate_variance` and
`filter_variance` run `models.denoiser.svgf_estimate_variance` /
`svgf_filter_variance` on the card as two small kernels.

CPU tensors take the twins, CUDA tensors the kernels in `csrc/svgf.cu`.
Nothing falls back. Packs are flat [C, R] float32. A row band
(`restir_tpu_torch.parallel`) passes B5 its previous pack with
+-`window` halos and that pack's first global pixel `prev_base`, as the
JAX `svgf_temporal_pallas(prev_base=, window=)`.
"""

from __future__ import annotations

import torch

from ...models import denoiser
from . import _build
from .fused_di import (
    G_MISS,
    G_MOTION,
    G_NORM,
    G_PRIMR,
    GB_CH,
    NULL,
    TILE,
    WINDOW,
    _check,
    _trunc_i32,
    _window_start,
    check_window,
    rebase_motion,
)

# ---- svgf pack channel layout ([SV_CH, R]), fused_di.SV_* ----
SV_COL = 0  # 3: colour history (level-0 wavelet output)
SV_M1 = 3  # E[lum]
SV_M2 = 4  # E[lum^2]
SV_HIST = 5  # history length
SV_PRIM = 6  # prim remap of the frame that wrote the pack
SV_NORM = 7  # 3
SV_CH = 16

temporal_launches = 0  # B5 launches
variance_launches = 0  # launches of the two variance kernels


def svgf_temporal_ref(gb, color, prev, *, prev_base=0, window=WINDOW):
    """Plain twin of B5: gb [GB_CH, r], demodulated colour [3, r] and the
    previous svgf pack [SV_CH, r_prev] from global pixel `prev_base` (the
    whole frame's, or a band's with +-`window` halos) -> the accumulated
    pack [SV_CH, r]."""
    check_window(window)
    r = gb.shape[1]
    r_prev = prev.shape[1]
    mo = rebase_motion(gb[G_MOTION], prev_base)
    w0 = _window_start(mo.view(-1, TILE), gb[G_MISS].view(-1, TILE),
                       r_prev, window).repeat_interleave(TILE)
    motion = _trunc_i32(mo).to(torch.int64)
    rel = motion - w0
    in_win = ((motion >= 0) & (rel >= 0) & (rel < window)
              & (motion < r_prev))
    h = prev[:, torch.where(in_win, motion, w0)]
    cx, cy, cz = color[0], color[1], color[2]
    lum = 0.2126 * cx + 0.7152 * cy + 0.0722 * cz
    prim = gb[G_PRIMR]
    gn = gb[G_NORM:G_NORM + 3]
    ndot = (gn[0] * h[SV_NORM] + gn[1] * h[SV_NORM + 1]
            + gn[2] * h[SV_NORM + 2])
    reset = (~in_win | (prim <= NULL) | (h[SV_PRIM] != prim)
             | (torch.abs(ndot) < 0.1))
    a = denoiser.SVGF_ALPHA
    out = torch.zeros((SV_CH, r), dtype=torch.float32, device=gb.device)
    out[SV_COL:SV_COL + 3] = torch.where(
        reset[None], color, h[SV_COL:SV_COL + 3]
        + (color - h[SV_COL:SV_COL + 3]) * a)
    lum2 = lum * lum
    out[SV_M1] = torch.where(reset, lum, h[SV_M1] + (lum - h[SV_M1]) * a)
    out[SV_M2] = torch.where(reset, lum2, h[SV_M2] + (lum2 - h[SV_M2]) * a)
    out[SV_HIST] = torch.where(reset, 0.0, h[SV_HIST] + 1.0)
    out[SV_PRIM] = prim
    out[SV_NORM:SV_NORM + 3] = gn
    return out


def svgf_temporal_cuda(gb, color, prev, *, prev_base=0, window=WINDOW):
    """Launch B5 (`svgf_temporal_kernel`)."""
    global temporal_launches
    r = gb.shape[1]
    dev = gb.device
    if r % TILE != 0:
        raise ValueError(f"pixel count {r} is not a multiple of {TILE}")
    check_window(window)
    _check(gb, "gb", (GB_CH, r), dev)
    _check(color, "color", (3, r), dev)
    _check(prev, "prev", (SV_CH, prev.shape[1]), dev)
    out = torch.empty((SV_CH, r), dtype=torch.float32, device=dev)
    p = _build.ptr
    lib = _build.library()
    with _build.on_device(dev):
        err = lib.restir_svgf_temporal(
            p(gb), p(color), p(prev), p(out), r, prev.shape[1], prev_base,
            window, _build.stream_of(dev))
    _build.check(err, "restir_svgf_temporal")
    temporal_launches += 1
    return out


def svgf_temporal(gb, color, prev, *, prev_base=0, window=WINDOW):
    """The accumulated svgf pack [SV_CH, r]: the twin on CPU tensors, B5
    on CUDA tensors."""
    kw = dict(prev_base=prev_base, window=window)
    if gb.device.type == "cpu":
        return svgf_temporal_ref(gb, color, prev, **kw)
    if gb.device.type == "cuda":
        return svgf_temporal_cuda(gb, color, prev, **kw)
    raise ValueError(f"unsupported device {gb.device}")


def _launch_plane(name, src, shape, width, height):
    """Launch the variance kernel `name` on `src` -> a plane [R]."""
    global variance_launches
    dev = src.device
    _check(src, "input", shape, dev)
    out = torch.empty((width * height,), dtype=torch.float32, device=dev)
    fn = getattr(_build.library(), name)
    with _build.on_device(dev):
        err = fn(_build.ptr(src), _build.ptr(out), width, height,
                 _build.stream_of(dev))
    _build.check(err, name)
    variance_launches += 1
    return out


def estimate_variance(sv, *, width, height):
    """Variance [R] of an accumulated svgf pack [SV_CH, R]."""
    if sv.device.type == "cpu":
        m = sv[SV_M1:SV_M1 + 3].reshape(3, height, width)
        return denoiser.svgf_estimate_variance(m).reshape(-1)
    if sv.device.type == "cuda":
        return _launch_plane("restir_svgf_variance", sv,
                             (SV_CH, width * height), width, height)
    raise ValueError(f"unsupported device {sv.device}")


def filter_variance(var, *, width, height):
    """3x3 Gaussian of a variance plane [R]."""
    if var.device.type == "cpu":
        return denoiser.svgf_filter_variance(
            var.reshape(height, width)).reshape(-1)
    if var.device.type == "cuda":
        return _launch_plane("restir_svgf_filter_variance", var,
                             (width * height,), width, height)
    raise ValueError(f"unsupported device {var.device}")
