"""Fused ReSTIR DI frame, as `restir_tpu.models.restir_di_fused` (the EAW
denoiser included).

A frame on a scene of at most 1024 triangles runs B1 (`di_resident`: hit,
G-buffer, RIS, visibility, temporal merge, brute force over the resident
triangles); a larger scene runs B6 (`gbuffer_pack`: MTBVH closest hit +
G-buffer) and B7 (`reuse`: RIS + MTBVH any-hit shadow ray, then B1's
temporal merge) in its place, as the JAX step switches to its streaming
kernels. Then B2 (`spatial_shade`: spatial merge, shade, running mean
into the accumulator) and B3 (`atrous_level`, once per EAW level).
State packs are flat channel-major [C, R] float32 tensors with the JAX
package's channel layout; `looper` and `iteration` are Python ints, so a
frame never waits on the device for them.

The temporal window and the per-tile spatial offsets work on 1024-pixel
tiles, so the pixel count must be a multiple of 1024.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DenoiserType, RenderConfig, ReuseMode, TracerType
from ..ops.camera import Camera, pack_camera
from ..ops.kernels import atrous, fused_di, gbuffer, reuse, spatial
from ..ops.kernels.fused_di import G_ALB, PT_CH, TILE
from ..scene.scene_data import SceneTensors

RESIDENT_MAX_TRIS = 1024  # larger scenes take the MTBVH kernels B6 + B7


class FusedDIState(NamedTuple):
    looper: int  # RNG epoch (uint32)
    iteration: int  # accumulation frame count
    accum: torch.Tensor  # [3, R] running-mean direct radiance
    pt_pack: torch.Tensor  # [PT_CH, R] post-temporal reuse pack
    svgf_pack: torch.Tensor  # [1, 1, 1] (SVGF is not ported)
    accum_ind: torch.Tensor  # [1, 1, 1] (DI only)
    gi_q: torch.Tensor  # [1, 1, 1] (DI only)
    last_camera: Camera


def ineligibility(scene: Optional[SceneTensors], cfg: RenderConfig):
    """Why `cfg` cannot run on the ported fused path (None if it can).
    Each reason names the ROADMAP item that will bring it."""
    reasons = []
    if cfg.tracer != TracerType.RESTIR_DI:
        reasons.append(f"tracer {cfg.tracer} (ROADMAP Queue A 6/7: GI, "
                       "PT and the general pipeline)")
    if cfg.ris_mode not in ("auto", "cdf"):
        reasons.append(f"ris_mode {cfg.ris_mode!r} (ROADMAP Queue A 7)")
    if cfg.sampler != "pcg4d":
        reasons.append(f"sampler {cfg.sampler!r} (ROADMAP Queue A 7)")
    if cfg.denoiser not in (DenoiserType.NONE, DenoiserType.EAW):
        reasons.append("SVGF denoiser (ROADMAP Queue A 4)")
    if cfg.has_env_map or cfg.with_textures or (
            scene is not None and (scene.has_env_map or scene.has_textures)):
        reasons.append("env map / textures (ROADMAP: B1 env/texture "
                       "branches)")
    if cfg.enable_dof:
        reasons.append("thin-lens DoF (ROADMAP Queue A 7)")
    if cfg.num_pixels % TILE != 0:
        reasons.append(f"{cfg.num_pixels} pixels, not a multiple of {TILE}")
    if cfg.intersector not in ("auto", "brute", "clustered"):
        reasons.append(f"intersector {cfg.intersector!r} (ROADMAP Queue A 5)")
    return "; ".join(reasons) or None


def _empty(device):
    return torch.zeros((1, 1, 1), dtype=torch.float32, device=device)


def _copy_camera(cam: Camera) -> Camera:
    return Camera(*(torch.as_tensor(x, dtype=torch.float32).clone()
                    for x in cam))


def init_state(cfg: RenderConfig, cam: Camera,
               device="cuda") -> FusedDIState:
    r = cfg.num_pixels
    dev = torch.device(device)
    return FusedDIState(
        looper=0,
        iteration=0,
        accum=torch.zeros((3, r), dtype=torch.float32, device=dev),
        pt_pack=torch.zeros((PT_CH, r), dtype=torch.float32, device=dev),
        svgf_pack=_empty(dev),
        accum_ind=_empty(dev),
        gi_q=_empty(dev),
        last_camera=_copy_camera(cam),
    )


def reset_accumulation(state: FusedDIState) -> FusedDIState:
    return state._replace(
        iteration=0,
        accum=torch.zeros_like(state.accum),
        pt_pack=torch.zeros_like(state.pt_pack),
    )


def step_fused(scene: SceneTensors, state: FusedDIState, cam: Camera,
               cfg: RenderConfig):
    """One fused frame. Returns (state', frame [3, R]).

    The step consumes `state`, as the JAX step donates it: kernel B2
    updates `state.accum` in place and the new state holds that tensor.
    Without a denoiser the frame is that accumulator too."""
    reason = ineligibility(scene, cfg)
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
              has_met=cfg.scene_has_metallic)
    if scene.num_tris <= RESIDENT_MAX_TRIS:
        gb, pt = fused_di.di_resident(
            cam_vec, lcam_vec, looper, state.pt_pack, scene.tables,
            width=w, height=h, aa_jitter=cfg.aa_jitter, **kw)
    else:
        gb = gbuffer.gbuffer_pack(
            cam_vec, lcam_vec, looper, scene.bvh, width=w, height=h,
            aa_jitter=cfg.aa_jitter, single_sided=cfg.single_sided_lights)
        pt = reuse.reuse(gb, state.pt_pack, looper, scene.tables, scene.bvh,
                         **kw)

    reuse_spatial = bool(cfg.reuse & ReuseMode.SPATIAL)
    offs = spatial.spatial_offsets(looper, r, w, cfg.spatial_neighbors,
                                   cfg.spatial_radius, dev)
    accum = spatial.spatial_shade(
        offs, gb, pt, state.accum, looper, state.iteration,
        width=w, height=h, neighbors=cfg.spatial_neighbors,
        accumulate=cfg.accumulate, reuse_spatial=reuse_spatial,
        has_met=cfg.scene_has_metallic)

    frame = accum
    if cfg.denoiser == DenoiserType.EAW:
        frame = eaw_filter_packed(frame, gb, cfg)

    next_state = state._replace(
        looper=(looper + 1) & 0xFFFFFFFF,
        iteration=state.iteration + 1,
        accum=accum,
        pt_pack=pt,
        last_camera=_copy_camera(cam),
    )
    return next_state, frame


def eaw_filter_packed(frame: torch.Tensor, gb_pack: torch.Tensor,
                      cfg: RenderConfig) -> torch.Tensor:
    """EAW à-trous chain on [3, R]: demodulate by the G-buffer albedo,
    run `cfg.eaw_levels` levels of kernel B3, modulate back."""
    albedo = torch.clamp(gb_pack[G_ALB:G_ALB + 3], min=0.0)
    if cfg.modulate_albedo:
        safe = torch.where(albedo > 1e-4, albedo, 1.0)
        color = frame / safe
    else:
        safe = None
        color = frame
    for level in range(cfg.eaw_levels):
        color = atrous.atrous_level(
            color.contiguous(), gb_pack, level=level, width=cfg.width,
            height=cfg.height, sig_l=cfg.sig_luminance,
            sig_n=cfg.sig_normal, sig_d=cfg.sig_depth)
    return color if safe is None else color * safe
