"""Fused ReSTIR DI frame, as `restir_tpu.models.restir_di_fused` (the EAW
denoiser included).

A frame on a scene of at most 1024 triangles runs B1 (`di_resident`: hit,
G-buffer, RIS, visibility, temporal merge on the resident tables, its
rays MTBVH walks); a larger scene runs B6 (`gbuffer_pack`: MTBVH closest hit +
G-buffer) and B7 (`reuse`: RIS + MTBVH any-hit shadow ray, then B1's
temporal merge) in its place, as the JAX step switches to its streaming
kernels. Then B2 (`spatial_shade`: spatial merge, shade, running mean
into the accumulator) and the denoiser: B3 (`atrous_level`, once per EAW
level), or SVGF (B5 `svgf_temporal`, the variance estimate, then per
level the variance prefilter and B4 `atrous_svgf_level`).
`cfg.has_env_map` adds the env map (env-tile light rows, env background
on misses) and `cfg.with_textures` the texture maps to B1 / B6 / B7.
State packs are flat channel-major [C, R] float32 tensors with the JAX
package's channel layout; `looper` and `iteration` are Python ints, so a
frame never waits on the device for them.

RESTIR_GI adds the GI stage after B2 (`_gi_stage`): B8 traces one path
per pixel from B1's G-buffer, B9 resolves it against the previous
frame's resolve pack; its running mean `accum_ind` joins the frame
before the denoiser.

The temporal window and the per-tile spatial offsets work on 1024-pixel
tiles; the gate (`ineligibility`) is the JAX package's: width a multiple
of 128, height of 8, and for RESTIR_GI the GI gate
(`restir_gi.gi_resolve_fused_eligible`: pcg4d, no env map, no textures,
at most 1024 triangles, whole 1024-pixel tiles). A config that fails it
renders on the general path (`renderer`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DenoiserType, RenderConfig, ReuseMode, TracerType
from ..ops.camera import Camera, pack_camera
from ..ops.kernels import atrous, fused_di, gbuffer, gi, reuse, spatial, svgf
from ..ops.kernels.fused_di import (
    G_ALB,
    G_DEPTH,
    G_DIR,
    G_METAL,
    G_MOTION,
    G_MTYPE,
    G_NORM,
    G_POS,
    G_PRIMR,
    G_ROUGH,
    G_SHADE,
    PT_CH,
    WINDOW,
)
from ..ops.kernels.svgf import SV_CH, SV_COL, SV_M1, SV_PRIM
from ..scene.scene_data import SceneTensors
from . import denoiser, restir_gi

RESIDENT_MAX_TRIS = 1024  # larger scenes take the MTBVH kernels B6 + B7


class FusedDIState(NamedTuple):
    looper: int  # RNG epoch (uint32)
    iteration: int  # accumulation frame count
    accum: torch.Tensor  # [3, R] running-mean direct radiance
    pt_pack: torch.Tensor  # [PT_CH, R] post-temporal reuse pack
    svgf_pack: torch.Tensor  # [SV_CH, R] with SVGF, else [1, 1, 1]
    accum_ind: torch.Tensor  # [3, R] indirect running mean ([1, 1, 1] DI)
    gi_q: torch.Tensor  # [Q_CH, R] GI resolve pack ([1, 1, 1] DI)
    last_camera: Camera


def ineligibility(cfg: RenderConfig, scene=None):
    """Why `cfg` does not take the fused path (None if it does), the
    gate of `restir_tpu.models.restir_di_fused.eligible`. RESTIR_GI's
    gate reads the scene (its triangle count and textures)."""
    reasons = []
    if cfg.tracer == TracerType.RESTIR_GI:
        if scene is None:
            reasons.append("RESTIR_GI without a scene (its gate reads it)")
        else:
            gate = restir_gi.gi_gate_failures(scene, cfg, cfg.num_pixels)
            if gate:
                reasons.append("GI resolve gate (gi_resolve_fused_eligible): "
                               + ", ".join(gate))
    elif cfg.tracer != TracerType.RESTIR_DI:
        reasons.append(f"tracer {cfg.tracer} (the general pipeline)")
    if cfg.ris_mode not in ("auto", "cdf"):
        reasons.append(f"ris_mode {cfg.ris_mode!r}")
    if cfg.sampler != "pcg4d":
        reasons.append(f"sampler {cfg.sampler!r}")
    if cfg.denoiser not in (DenoiserType.NONE, DenoiserType.EAW,
                            DenoiserType.SVGF):
        reasons.append(f"denoiser {cfg.denoiser}")
    if cfg.enable_dof:
        reasons.append("thin-lens DoF")
    # the JAX gate's 8x128-pixel tiles (fused_di.eligible); they also make
    # the pixel count a multiple of the 1024-pixel TILE
    if cfg.width % 128 != 0:
        reasons.append(f"width {cfg.width} not a multiple of 128")
    if cfg.height % 8 != 0:
        reasons.append(f"height {cfg.height} not a multiple of 8")
    if cfg.intersector not in ("auto", "brute", "clustered"):
        reasons.append(f"intersector {cfg.intersector!r}")
    return "; ".join(reasons) or None


def ineligibility_reason(cfg: RenderConfig, scene, device):
    """The notice `renderer.init_state` gives when a RESTIR_DI or
    RESTIR_GI config falls off the fused path on the card (None when it
    does not, for other tracers, which have no fused variant, and off
    the card, where the general path is the intended one), as
    `restir_tpu.models.restir_di_fused.ineligibility_reason`."""
    if cfg.tracer not in (TracerType.RESTIR_DI, TracerType.RESTIR_GI):
        return None
    if torch.device(device).type != "cuda":
        return None
    return ineligibility(cfg, scene)


def _empty(device):
    return torch.zeros((1, 1, 1), dtype=torch.float32, device=device)


def _copy_camera(cam: Camera) -> Camera:
    return Camera(*(torch.as_tensor(x, dtype=torch.float32).clone()
                    for x in cam))


def _svgf_history(r: int, device) -> torch.Tensor:
    """An empty svgf pack: prim history NULL, so the next frame
    disoccludes everywhere (0.0 would be a valid prim id)."""
    sv = torch.zeros((SV_CH, r), dtype=torch.float32, device=device)
    sv[SV_PRIM] = -1.0
    return sv


def init_state(cfg: RenderConfig, cam: Camera,
               device="cuda") -> FusedDIState:
    r = cfg.num_pixels
    dev = torch.device(device)
    with_gi = cfg.tracer == TracerType.RESTIR_GI

    def zeros(c):
        return torch.zeros((c, r), dtype=torch.float32, device=dev)

    return FusedDIState(
        looper=0,
        iteration=0,
        accum=zeros(3),
        pt_pack=zeros(PT_CH),
        svgf_pack=(_svgf_history(r, dev)
                   if cfg.denoiser == DenoiserType.SVGF else _empty(dev)),
        accum_ind=zeros(3) if with_gi else _empty(dev),
        gi_q=zeros(gi.Q_CH) if with_gi else _empty(dev),
        last_camera=_copy_camera(cam),
    )


def reset_accumulation(state: FusedDIState) -> FusedDIState:
    sv = state.svgf_pack
    return state._replace(
        iteration=0,
        accum=torch.zeros_like(state.accum),
        pt_pack=torch.zeros_like(state.pt_pack),
        svgf_pack=(_svgf_history(sv.shape[1], sv.device)
                   if sv.shape[0] == SV_CH else torch.zeros_like(sv)),
        accum_ind=torch.zeros_like(state.accum_ind),
        gi_q=torch.zeros_like(state.gi_q),
    )


def step_fused(scene: SceneTensors, state: FusedDIState, cam: Camera,
               cfg: RenderConfig):
    """One fused frame. Returns (state', frame [3, R]).

    The step consumes `state`, as the JAX step donates it: kernel B2
    updates `state.accum` in place and the new state holds that tensor.
    Without a denoiser (and without GI) the frame is that accumulator
    too."""
    reason = ineligibility(cfg, scene)
    if reason is not None:
        raise NotImplementedError(f"fused DI path: {reason}")
    dev = state.pt_pack.device
    w, h = cfg.width, cfg.height
    r = cfg.num_pixels
    looper = state.looper & 0xFFFFFFFF

    cam_vec = pack_camera(cam, dev)
    lcam_vec = pack_camera(state.last_camera, dev)
    kw = dict(single_sided=cfg.single_sided_lights, k=cfg.cdf_candidates,
              temporal=bool(cfg.reuse & ReuseMode.TEMPORAL),
              temporal_clamp=cfg.temporal_clamp,
              has_met=cfg.scene_has_metallic, has_env=cfg.has_env_map)
    if scene.num_tris <= RESIDENT_MAX_TRIS:
        gb, pt = fused_di.di_resident(
            cam_vec, lcam_vec, looper, state.pt_pack, scene.tables,
            scene.bvh, width=w, height=h, aa_jitter=cfg.aa_jitter,
            with_textures=cfg.with_textures, **kw)
    else:
        gb = gbuffer.gbuffer_pack(
            cam_vec, lcam_vec, looper, scene.bvh, width=w, height=h,
            aa_jitter=cfg.aa_jitter, single_sided=cfg.single_sided_lights,
            has_env=cfg.has_env_map, with_textures=cfg.with_textures)
        pt = reuse.reuse(gb, state.pt_pack, looper, scene.tables, scene.bvh,
                         width=w, **kw)

    reuse_spatial = bool(cfg.reuse & ReuseMode.SPATIAL)
    offs = spatial.spatial_offsets(looper, r, w, cfg.spatial_neighbors,
                                   cfg.spatial_radius, dev)
    accum = spatial.spatial_shade(
        offs, gb, pt, state.accum, looper, state.iteration,
        width=w, height=h, neighbors=cfg.spatial_neighbors,
        accumulate=cfg.accumulate, reuse_spatial=reuse_spatial,
        has_met=cfg.scene_has_metallic)

    frame = accum
    accum_ind, gi_q = state.accum_ind, state.gi_q
    if cfg.tracer == TracerType.RESTIR_GI:
        ind, gi_q = _gi_stage(scene, gb, state.gi_q, cfg, looper)
        if cfg.accumulate:
            it_f = float(state.iteration)
            accum_ind = (state.accum_ind * it_f + ind) / (it_f + 1.0)
        else:
            accum_ind = ind
        frame = accum + accum_ind
    svgf_pack = state.svgf_pack
    if cfg.denoiser == DenoiserType.EAW:
        frame = eaw_filter_packed(frame, gb, cfg)
    elif cfg.denoiser == DenoiserType.SVGF:
        (frame,), (svgf_pack,) = svgf_filter_packed([frame], [gb],
                                                    [svgf_pack], cfg)

    next_state = state._replace(
        looper=(looper + 1) & 0xFFFFFFFF,
        iteration=state.iteration + 1,
        accum=accum,
        pt_pack=pt,
        svgf_pack=svgf_pack,
        accum_ind=accum_ind,
        gi_q=gi_q,
        last_camera=_copy_camera(cam),
    )
    return next_state, frame


def gi_packs(scene: SceneTensors, gb):
    """(IN pack [IN_CH, R], GQ pack [GQ_CH, R]) of the GI stage from the
    fused G-buffer pack (restir_di_fused.py:297-334)."""
    # the gb pack has no ior: read the material row of the lane's matId
    # (0 for NULL and LIGHT_ID lanes, as the JAX where chain leaves them)
    matid = gb[G_PRIMR]
    n_mat = scene.mat_attr.shape[0]
    ior = torch.where((matid >= 0.0) & (matid < n_mat),
                      scene.mat_attr[:, 6][matid.clamp(0, n_mat - 1).long()],
                      0.0)
    zero = torch.zeros_like(ior)
    in_pack = torch.cat([
        gb[G_POS:G_POS + 3], gb[G_NORM:G_NORM + 3], gb[G_DIR:G_DIR + 3],
        gb[G_MTYPE:G_MTYPE + 1], gb[G_METAL:G_METAL + 1],
        gb[G_ROUGH:G_ROUGH + 1], ior[None],
        gb[G_SHADE:G_SHADE + 1],  # alive = valid & ~is_light
        zero[None], zero[None]])
    gq = torch.cat([
        gb[G_MOTION:G_MOTION + 1], gb[G_PRIMR:G_PRIMR + 1],
        gb[G_DEPTH:G_DEPTH + 1], gb[G_NORM:G_NORM + 3],
        gb[G_ALB:G_ALB + 3], gb[G_SHADE:G_SHADE + 1]])
    return in_pack, gq


def _gi_stage(scene: SceneTensors, gb, gi_q, cfg: RenderConfig, looper):
    """ReSTIR GI on the fused G-buffer pack (restir_di_fused.py:286-340):
    B8 traces from B1's hits, B9 resolves -> (indirect [3, R], next
    resolve pack [Q_CH, R])."""
    in_pack, gq = gi_packs(scene, gb)
    go = gi.gi_trace(in_pack, looper, scene,
                     **restir_gi.trace_kwargs(scene, cfg))
    return gi.gi_resolve(go, in_pack, gq, gi_q, looper,
                         temporal=bool(cfg.reuse & ReuseMode.TEMPORAL),
                         temporal_clamp=cfg.temporal_clamp,
                         has_met=cfg.scene_has_metallic)


def _demod(frame, gb_pack, cfg: RenderConfig):
    """(frame / albedo, albedo) with albedos <= 1e-4 read as 1, or
    (frame, None) without `modulate_albedo`."""
    if not cfg.modulate_albedo:
        return frame, None
    albedo = torch.clamp(gb_pack[G_ALB:G_ALB + 3], min=0.0)
    safe = torch.where(albedo > 1e-4, albedo, 1.0)
    return frame / safe, safe


def eaw_filter_packed(frame: torch.Tensor, gb_pack: torch.Tensor,
                      cfg: RenderConfig) -> torch.Tensor:
    """EAW à-trous chain on [3, R]: demodulate by the G-buffer albedo,
    run `cfg.eaw_levels` levels of kernel B3, modulate back."""
    color, safe = _demod(frame, gb_pack, cfg)
    for level in range(cfg.eaw_levels):
        color = atrous.atrous_level(
            color.contiguous(), gb_pack, level=level, width=cfg.width,
            height=cfg.height, sig_l=cfg.sig_luminance,
            sig_n=cfg.sig_normal, sig_d=cfg.sig_depth)
    return color if safe is None else color * safe


def svgf_filter_packed(frames, gb_packs, svgf_prevs, cfg: RenderConfig,
                       image=None, prev_base=(0,), window=WINDOW):
    """SVGF on each band's [3, r] frame (denoiser.cu:479-568): demodulate,
    accumulate with the history (B5: band b's previous svgf pack
    `svgf_prevs[b]` starts at global pixel `prev_base[b]`), then
    `svgf_wavelets` on the band's image (`image` as in
    `denoiser.eaw_filter`; default: one band, the whole frame). Returns
    (filtered frames, next svgf packs); the colour history fed forward is
    the level-0 output (denoiser.cu:542-543)."""
    image = image or denoiser.whole_frame(cfg.height)
    demods = [_demod(f, g, cfg) for f, g in zip(frames, gb_packs)]
    svs = [svgf.svgf_temporal(g, d.contiguous(), p, prev_base=base,
                              window=window)
           for (d, _), g, p, base in zip(demods, gb_packs, svgf_prevs,
                                         prev_base)]
    out, history = [], []
    for b, (_, safe) in enumerate(demods):
        (sv, gb_img), h, o = image([svs, gb_packs], b)
        color, hist = svgf_wavelets(sv, gb_img, cfg.replace(height=h))
        r = svs[b].shape[1]
        color = color[:, o:o + r]
        out.append(color.contiguous() if safe is None else color * safe)
        history.append(hist[:, o:o + r])
    # every band's image is cut before a history is written back
    for sv, hist in zip(svs, history):
        sv[SV_COL:SV_COL + 3] = hist
    return out, svs


def svgf_wavelets(sv: torch.Tensor, gb_pack: torch.Tensor,
                  cfg: RenderConfig):
    """SVGF's spatial half on an accumulated svgf pack of a cfg.width x
    cfg.height image: estimate the variance with level 0's prefilter
    (one kernel on the pack's moment rows), then per level run B4, and
    before levels 1.. prefilter B4's variance. Returns (demodulated
    colour [3, R], the level-0 output, which is the colour history)."""
    w, h = cfg.width, cfg.height
    var, fv = svgf.estimate_variance(sv[SV_M1:SV_M1 + 3], width=w, height=h)
    color = sv[SV_COL:SV_COL + 3]
    history = color
    for level in range(cfg.eaw_levels):
        if level > 0:
            fv = svgf.filter_variance(var, width=w, height=h)
        color, var = atrous.atrous_svgf_level(
            color.contiguous(), var, fv, gb_pack, level=level, width=w,
            height=h, sig_l=cfg.sig_luminance, sig_n=cfg.svgf_sig_normal,
            sig_d=cfg.svgf_sig_depth)
        if level == 0:
            history = color
    return color, history
