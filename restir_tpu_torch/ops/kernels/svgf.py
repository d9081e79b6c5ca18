"""Kernel B5 (SVGF temporal accumulation) and the SVGF variance passes,
with their plain PyTorch twins.

`svgf_temporal` ports `restir_tpu.ops.pallas.fused_di._svgf_temporal_kernel`
(`svgf_temporal_pallas`; temporalAccumulate, denoiser.cu:250-305): per
pixel, the previous svgf pack's column at the motion index (inside the
tile's 2048-pixel window), the disocclusion reset (window miss, NULL
prim, prim mismatch, |n.n'| < 0.1) and the alpha = 0.2 blend of colour
and of the (lum, lum^2) moments. `estimate_variance` runs
`models.denoiser.svgf_estimate_variance` and level 0's
`svgf_filter_variance` of its result on the card as one kernel, and
`filter_variance` the prefilter of levels 1-4: SVGF launches 1 + 4 of
them per frame. The variance kernel reads the moments through their
strides, so neither the fused pack's rows nor the general path's
[R, 3] history is copied for it.

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
variance_launches = 0  # launches of the variance kernels (estimate +
#                         level-0 prefilter: one; a later prefilter: one)


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


def _planes(n, width, height, dev):
    return [torch.empty((width * height,), dtype=torch.float32, device=dev)
            for _ in range(n)]


def _launched(err, name):
    global variance_launches
    _build.check(err, name)
    variance_launches += 1


def estimate_variance(moments, *, width, height):
    """(variance [R], its level-0 prefilter [R]) of the moments [3, R]:
    E[lum], E[lum^2] and the history length, with any strides (an svgf
    pack's rows SV_M1..SV_HIST, or the general path's [R, 3] history
    transposed). One kernel launch on CUDA tensors; on CPU tensors
    `denoiser.svgf_estimate_variance`, then `svgf_filter_variance`."""
    r = width * height
    if (moments.dim() != 2 or tuple(moments.shape) != (3, r)
            or moments.dtype != torch.float32):
        raise ValueError(f"moments: expected float32 [3, {r}], got "
                         f"{moments.dtype} {tuple(moments.shape)}")
    if moments.device.type == "cpu":
        var = denoiser.svgf_estimate_variance(moments.reshape(3, height,
                                                              width))
        return (var.reshape(-1),
                denoiser.svgf_filter_variance(var).reshape(-1))
    if moments.device.type == "cuda":
        dev = moments.device
        var, fv = _planes(2, width, height, dev)
        cs, ps = moments.stride()
        p = _build.ptr
        with _build.on_device(dev):
            err = _build.library().restir_svgf_variance(
                p(moments), cs, ps, p(var), p(fv), width, height,
                _build.stream_of(dev))
        _launched(err, "restir_svgf_variance")
        return var, fv
    raise ValueError(f"unsupported device {moments.device}")


def filter_variance(var, *, width, height):
    """3x3 Gaussian of a variance plane [R] (the prefilter of levels
    1-4; `estimate_variance` returns level 0's)."""
    if var.device.type == "cpu":
        return denoiser.svgf_filter_variance(
            var.reshape(height, width)).reshape(-1)
    if var.device.type == "cuda":
        dev = var.device
        _check(var, "variance", (width * height,), dev)
        (out,) = _planes(1, width, height, dev)
        with _build.on_device(dev):
            err = _build.library().restir_svgf_filter_variance(
                _build.ptr(var), _build.ptr(out), width, height,
                _build.stream_of(dev))
        _launched(err, "restir_svgf_filter_variance")
        return out
    raise ValueError(f"unsupported device {var.device}")
