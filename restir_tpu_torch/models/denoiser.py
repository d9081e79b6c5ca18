"""Denoisers of the general path, as `restir_tpu.models.denoiser`: the
À-trous EAW wavelet filter and SVGF on `GBufferFrame`s (denoiser.cu).

`eaw_filter` and `svgf_filter` take the general path's [R, 3] frame,
demodulate it by the G-buffer albedo and run `cfg.eaw_levels` à-trous
levels on the hand kernels the fused path runs: B3
(`ops.kernels.atrous.atrous_level`) for EAW; for SVGF the variance
estimate with level 0's prefilter (`ops.kernels.svgf.estimate_variance`),
the prefilter of levels 1.. (`filter_variance`) and B4
(`atrous_svgf_level`). They read a
[GB_CH, R] pack built from the G-buffer (`gbuffer_pack`: prim in
G_PRIMR, normal, position). CPU tensors take the kernels' plain twins.

`denoise` runs the configured filter on a list of frames, one per row
band (a single one on one device). Every filter runs one sequence for
both: per band it demodulates (and, for SVGF, accumulates against the
history), then asks an image provider for each band's image of the
planes its taps read, runs the spatial chain (`eaw_levels`,
`svgf_levels`) on it and crops the band's pixels. The default provider
(`whole_frame`) hands back the one band's own planes;
`restir_tpu_torch.parallel.sharding.band_images` gathers a band's rows
and the rows its taps reach from every band. SVGF's temporal step then
reads a fetched range of the previous history (`prev`: per band the
columns of global pixels from a base).

SVGF's temporal step (`svgf_temporal_accumulate`, temporalAccumulate,
denoiser.cu:250-305) gathers the history at `gb.motion` from anywhere in
the frame, as the JAX package's XLA gather does; the fused path's kernel
B5 reads only a 2048-pixel window and blends as h + (c - h) a, so it
does not carry this step, which stays torch glue.

`svgf_estimate_variance` (estimateVariance, denoiser.cu:307-343) and
`svgf_filter_variance` (filterVariance, denoiser.cu:345-371) on planes
are the twins of the variance kernels in `csrc/svgf.cu` (the first runs
both, the second the prefilter alone).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DenoiserType
from ..ops.kernels.atrous import _shift

SVGF_ALPHA = 0.2  # denoiser.cu:256
SVGF_HISTORY_THRESHOLD = 3.5  # denoiser.cu:317
NULL_PRIMITIVE = -1

# 3x3 Gaussian, denoiser.cu:19-23 (float32 values)
GAUSSIAN_3 = (
    (0.075, 0.124, 0.075),
    (0.124, 0.204, 0.124),
    (0.075, 0.124, 0.075),
)


class SVGFState(NamedTuple):
    """The general path's SVGF history (devAccumColor / devAccumMoment,
    denoiser.cu:479-492)."""

    accum_color: torch.Tensor  # [R, 3] level-0 filtered colour
    accum_moment: torch.Tensor  # [R, 3] (E[lum], E[lum^2], history)


def init_svgf_state(num_pixels: int, device="cuda") -> SVGFState:
    z = torch.zeros((num_pixels, 3), dtype=torch.float32, device=device)
    return SVGFState(accum_color=z, accum_moment=z.clone())


def svgf_estimate_variance(moment_chw: torch.Tensor) -> torch.Tensor:
    """Variance [H, W] from the moments (E[lum], E[lum^2], history) [3, H,
    W]: temporal where the history is over 3.5 frames, else from the 3x3
    spatial moment means."""
    m1, m2, hist = moment_chw[0], moment_chw[1], moment_chw[2]
    temporal_var = m2 - m1 * m1
    inb = torch.ones_like(m1)
    s1 = torch.zeros_like(m1)
    s2 = torch.zeros_like(m1)
    cnt = torch.zeros_like(m1)
    for i in range(-1, 2):
        for j in range(-1, 2):
            s1 = s1 + _shift(m1, i, j)
            s2 = s2 + _shift(m2, i, j)
            cnt = cnt + _shift(inb, i, j)
    mean = s1 / cnt
    spatial_var = s2 / cnt - mean * mean
    return torch.where(hist > SVGF_HISTORY_THRESHOLD, temporal_var,
                       spatial_var)


def svgf_filter_variance(var: torch.Tensor) -> torch.Tensor:
    """3x3 Gaussian prefilter of the variance [H, W], normalised by the
    in-frame weights."""
    inb = torch.ones_like(var)
    s = torch.zeros_like(var)
    sw = torch.zeros_like(var)
    for i in range(-1, 2):
        for j in range(-1, 2):
            g = GAUSSIAN_3[i + 1][j + 1]
            s = s + _shift(var, i, j) * g
            sw = sw + _shift(inb, i, j) * g
    return s / torch.clamp(sw, min=1e-20)


def gbuffer_pack(gb) -> torch.Tensor:
    """The [GB_CH, R] pack the à-trous kernels read (G_PRIMR, G_NORM,
    G_POS) from a `GBufferFrame`; the other channels are zero."""
    from ..ops.kernels.fused_di import G_NORM, G_POS, G_PRIMR, GB_CH

    pack = torch.zeros((GB_CH, gb.pos.shape[0]), dtype=torch.float32,
                       device=gb.pos.device)
    pack[G_PRIMR] = gb.prim_id.to(torch.float32)
    pack[G_NORM:G_NORM + 3] = gb.norm.T
    pack[G_POS:G_POS + 3] = gb.pos.T
    return pack


def _demodulate(frame, gb, cfg):
    """(frame / albedo, albedo) with albedos <= 1e-4 read as 1; (frame,
    ones) without `modulate_albedo`."""
    if not cfg.modulate_albedo:
        return frame, torch.ones_like(frame)
    albedo = torch.clamp(gb.albedo, min=0.0)
    safe = torch.where(albedo > 1e-4, albedo, 1.0)
    return frame / safe, safe


def eaw_levels(color: torch.Tensor, gb_pack: torch.Tensor,
               cfg) -> torch.Tensor:
    """`cfg.eaw_levels` levels of B3 on a demodulated [3, H W] image of
    cfg's size."""
    from ..ops.kernels import atrous

    for level in range(cfg.eaw_levels):
        color = atrous.atrous_level(
            color, gb_pack, level=level, width=cfg.width, height=cfg.height,
            sig_l=cfg.sig_luminance, sig_n=cfg.sig_normal,
            sig_d=cfg.sig_depth)
    return color


def whole_frame(height: int):
    """The image provider of a single band that is the whole frame of
    `height` rows: image(planes, 0) -> (band 0's planes, height, 0)."""
    return lambda planes, b: ([p[b] for p in planes], height, 0)


def eaw_filter(frames, gbs, cfg, image=None):
    """LeveledEAWFilter::filter (denoiser.cu:463-477): `cfg.eaw_levels`
    levels of B3 on each band's demodulated [r, 3] frame, modulated back.
    `image(planes, b)` takes lists of band planes [C, r] and gives band
    b's image of each, the image's height and the band's first pixel in
    it (default `whole_frame`: one band, the whole frame)."""
    image = image or whole_frame(cfg.height)
    demods = [_demodulate(f, g, cfg) for f, g in zip(frames, gbs)]
    colors = [d.T.contiguous() for d, _ in demods]
    packs = [gbuffer_pack(g) for g in gbs]
    out = []
    for b, (_, albedo) in enumerate(demods):
        (color, gb_img), h, o = image([colors, packs], b)
        color = eaw_levels(color, gb_img, cfg.replace(height=h))
        out.append(color[:, o:o + albedo.shape[0]].T * albedo)
    return out


def svgf_pack(state: SVGFState, last_gb) -> torch.Tensor:
    """The [C, R] channel pack `svgf_temporal_accumulate` gathers from:
    the history and the previous G-buffer's prim and normal."""
    from ..ops import reservoir as rsv

    return rsv.pack_channels((state.accum_color, state.accum_moment,
                              last_gb.prim_id, last_gb.norm))


def svgf_temporal_accumulate(color_in: torch.Tensor, gb, last_gb,
                             state: SVGFState, prev=None,
                             prev_base: int = 0) -> SVGFState:
    """temporalAccumulate (denoiser.cu:250-305): the history at the motion
    index, the disocclusion test (motion, prim, |n.n'| < 0.1) and the
    alpha blend of colour and of the (lum, lum^2) moments. `prev` is
    `svgf_pack`'s columns of global pixels prev_base .. (default: the
    whole of `state` and `last_gb`)."""
    from ..ops import reservoir as rsv
    from ..utils import math as mathx

    last_idx = gb.motion
    template = (state.accum_color, state.accum_moment, last_gb.prim_id,
                last_gb.norm)
    if prev is None:
        prev = rsv.pack_channels(template)
    rows = rsv.take_columns(prev, last_idx, prev_base)
    last_color, last_moment, lprim, lnorm = rsv.unpack_channels(rows,
                                                                template)
    diff = ((last_idx < 0) | (gb.prim_id <= NULL_PRIMITIVE)
            | (lprim != gb.prim_id)
            | (mathx.abs_dot(gb.norm, lnorm) < 0.1))
    lum = mathx.luminance(color_in)
    blended_color = mathx.mix(last_color, color_in, SVGF_ALPHA)
    blended_m1 = mathx.mix(last_moment[..., 0], lum, SVGF_ALPHA)
    blended_m2 = mathx.mix(last_moment[..., 1], lum * lum, SVGF_ALPHA)
    history = last_moment[..., 2] + 1.0
    accum_color = torch.where(diff[..., None], color_in, blended_color)
    accum_moment = torch.where(
        diff[..., None],
        torch.stack([lum, lum * lum, torch.zeros_like(lum)], dim=-1),
        torch.stack([blended_m1, blended_m2, history], dim=-1))
    return SVGFState(accum_color=accum_color, accum_moment=accum_moment)


def svgf_levels(color: torch.Tensor, moment: torch.Tensor,
                gb_pack: torch.Tensor, cfg):
    """SVGF's spatial chain on a [3, H W] image of cfg's size: the
    variance estimate from the [3, H W] moments (any strides: the
    kernel reads them in place) with level 0's prefilter, then
    `cfg.eaw_levels` levels of B4, with the prefilter of B4's variance
    before levels 1.. -> (filtered colour, the level-0 output: the colour
    history fed forward, denoiser.cu:542-543)."""
    from ..ops.kernels import atrous, svgf

    w, h = cfg.width, cfg.height
    var, fv = svgf.estimate_variance(moment, width=w, height=h)
    history = color
    for level in range(cfg.eaw_levels):
        if level > 0:
            fv = svgf.filter_variance(var, width=w, height=h)
        color, var = atrous.atrous_svgf_level(
            color.contiguous(), var.contiguous(), fv, gb_pack, level=level,
            width=w, height=h, sig_l=cfg.sig_luminance,
            sig_n=cfg.svgf_sig_normal, sig_d=cfg.svgf_sig_depth)
        if level == 0:
            history = color
    return color, history


def svgf_filter(frames, gbs, last_gbs, states, cfg, image=None,
                prev=None):
    """SpatioTemporalFilter::filter (denoiser.cu:537-564) on each band's
    [r, 3] frame -> (filtered frames, next SVGFStates); the colour
    history fed forward is the level-0 output (denoiser.cu:542-543).
    `image` as in `eaw_filter`; `prev` holds per band the (`svgf_pack`
    columns, first global pixel) its history is read from (default: the
    band's own `states` and `last_gbs`)."""
    image = image or whole_frame(cfg.height)
    prev = prev or [(None, 0)] * len(frames)
    demods = [_demodulate(f, g, cfg) for f, g in zip(frames, gbs)]
    acc = [svgf_temporal_accumulate(d, g, lg, s, p, base)
           for (d, _), g, lg, s, (p, base) in zip(demods, gbs, last_gbs,
                                                  states, prev)]
    colors = [a.accum_color.T.contiguous() for a in acc]
    moments = [a.accum_moment.T for a in acc]
    packs = [gbuffer_pack(g) for g in gbs]
    out, nxt = [], []
    for b, ((_, albedo), a) in enumerate(zip(demods, acc)):
        (color, moment, gb_img), h, o = image([colors, moments, packs], b)
        color, history = svgf_levels(color, moment, gb_img,
                                     cfg.replace(height=h))
        r = albedo.shape[0]
        out.append(color[:, o:o + r].T * albedo)
        nxt.append(SVGFState(accum_color=history[:, o:o + r].T.contiguous(),
                             accum_moment=a.accum_moment))
    return out, nxt


def denoise(frames, gbs, last_gbs, states, cfg, image=None, prev=None):
    """cfg's denoiser on the bands' frames (`eaw_filter`, `svgf_filter`,
    or none) -> (frames, next SVGFStates)."""
    if cfg.denoiser == DenoiserType.EAW:
        return eaw_filter(frames, gbs, cfg, image), states
    if cfg.denoiser == DenoiserType.SVGF:
        return svgf_filter(frames, gbs, last_gbs, states, cfg, image, prev)
    return frames, states
