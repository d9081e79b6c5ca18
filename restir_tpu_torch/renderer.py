"""Frame orchestration of the port, as `restir_tpu.renderer`.

`init_state` routes as the JAX package does: with a scene whose config
passes the fused gate (`restir_di_fused.ineligibility`) it returns a
`FusedDIState`; with no scene, or when the gate fails, the general
`RenderState`, and on the card a RESTIR_DI or RESTIR_GI config that
falls off the fused path is announced once per config. `step`
dispatches on the state's type. The general step carries every config
the JAX package's general step does: RESTIR_DI, RESTIR_GI (DI and GI in
one frame), PT_DIRECT, PT_FULL, PT_INDIRECT, BVH_VISUALIZE and
GBUFFER_PREVIEW, then the EAW or SVGF denoiser (`models.denoiser`), with
either sampler and any intersector at any triangle count. Entry points
run on the card (`device="cuda"`) unless the caller asks for the CPU.

The general step runs in stages (`general_gbuffer`, `general_trace`,
`general_shade`, then the denoiser), which
`restir_tpu_torch.parallel.make_sharded_step` runs on row bands with the
copies between bands in between.

The JAX package renders a 1080p general GI frame as two programs to fit
the TPU's memory (`restir_tpu.renderer.step_jit`); the port runs it as
one step.

`looper` and `iteration` are Python ints in both states, so a frame
never waits on the device for them.
"""

from __future__ import annotations

import types
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import convert
from .config import (
    DenoiserType,
    RenderConfig,
    ReuseMode,
    TracerType,
    validate_mat_flags,
)
from .models import denoiser as dn
from .models import restir_di, restir_di_fused, restir_gi
from .models import gbuffer as gbuf
from .models.denoiser import SVGFState
from .models.path_tracer import bvh_heatmap, pt_direct, pt_indirect, pt_trace
from .models.restir_di_fused import FusedDIState, _copy_camera
from .ops import reservoir as rsv
from .ops.camera import Camera
from .ops.tonemap import to_uint8, tonemap
from .scene.scene_data import SceneTensors


class RenderState(NamedTuple):
    looper: int  # RNG epoch (uint32)
    iteration: int  # accumulation frame count
    direct_illum: torch.Tensor  # [R, 3]
    indirect_illum: torch.Tensor  # [R, 3]
    dir_reservoir: rsv.Reservoir  # ReSTIR DI temporal feed
    gi_reservoir: object  # ReSTIR GI feed: Reservoir, or [Q_CH, R] pack
    gbuffer: gbuf.GBufferFrame  # previous frame's G-buffer
    last_camera: Camera
    denoiser: SVGFState


def _host_materials(scene: SceneTensors):
    """The two material arrays `config.mat_flags` reads, on the host."""
    return types.SimpleNamespace(mat_type=scene.mat_type.cpu().numpy(),
                                 mat_attr=scene.mat_attr.cpu().numpy())


def init_general(cfg: RenderConfig, cam: Camera, device="cuda",
                 scene: Optional[SceneTensors] = None) -> RenderState:
    """The general state. A RESTIR_GI config whose scene passes the GI
    gate carries its reservoir as the fused [Q_CH, R] resolve pack (B8 +
    B9 each frame), as the JAX package does on the TPU
    (`restir_tpu/renderer.py:80-92`); the port's kernels have CPU twins,
    so the choice is the same on either device."""
    r = cfg.num_pixels
    dev = torch.device(device)

    def z3():
        return torch.zeros((r, 3), dtype=torch.float32, device=dev)

    if (cfg.tracer == TracerType.RESTIR_GI and scene is not None
            and restir_gi.gi_resolve_fused_eligible(scene, cfg, r)):
        gi_res = restir_gi.init_gi_resolve_pack(r, dev)
    else:
        gi_res = rsv.zeros_indirect(r, dev)
    return RenderState(
        looper=0, iteration=0, direct_illum=z3(), indirect_illum=z3(),
        dir_reservoir=rsv.zeros_direct(r, dev),
        gi_reservoir=gi_res,
        gbuffer=gbuf.empty_gbuffer(r, dev), last_camera=_copy_camera(cam),
        denoiser=dn.init_svgf_state(r, dev))


_warned_fallback: set = set()


def init_state(cfg: RenderConfig, cam: Camera,
               scene: Optional[SceneTensors] = None, *, device="cuda"):
    """Render state for `cfg` on `device`: fused when a scene is given
    and the fused gate passes, else general. With `scene`, also checks
    the config's material and env flags against the scene, and on the
    card warns once per config when RESTIR_DI or RESTIR_GI falls off the
    fused path, naming the gate that failed."""
    if scene is not None:
        validate_mat_flags(cfg, _host_materials(scene))
        if cfg.has_env_map and not scene.has_env_map:
            raise ValueError("RenderConfig has_env_map is set but the scene "
                             "has no env map")
        if restir_di_fused.ineligibility(cfg, scene) is None:
            return restir_di_fused.init_state(cfg, cam, device)
        reason = restir_di_fused.ineligibility_reason(cfg, scene, device)
        if reason is not None and cfg not in _warned_fallback:
            _warned_fallback.add(cfg)
            warnings.warn("restir_tpu_torch: falling back to the general "
                          f"(slower) pipeline — {reason}", stacklevel=2)
    return init_general(cfg, cam, device, scene)


def reset_iteration(state):
    """Restart the running average only (main.cpp:158-162)."""
    return state._replace(iteration=0)


def reset_accumulation(state):
    """Camera-change reset: restart averaging and temporal history, keep
    the RNG epoch monotonic."""
    if isinstance(state, FusedDIState):
        return restir_di_fused.reset_accumulation(state)
    zero = torch.zeros_like
    return state._replace(
        iteration=0, direct_illum=zero(state.direct_illum),
        indirect_illum=zero(state.indirect_illum),
        dir_reservoir=rsv.tree_map(zero, state.dir_reservoir),
        gi_reservoir=rsv.tree_map(zero, state.gi_reservoir),
        denoiser=rsv.tree_map(zero, state.denoiser))


def _accumulate(prev, new, iteration: int, accumulate: bool):
    """Running mean (img * iter + x) / (iter + 1) — restir.cu:230."""
    if not accumulate:
        return new
    it = float(iteration)
    return (prev * it + new) / (it + 1.0)


def step(scene: SceneTensors, state, cam: Camera, cfg: RenderConfig):
    """One frame -> (next state, frame): [3, R] for a fused state (which
    the step consumes, see `restir_di_fused.step_fused`), [R, 3] for a
    general one."""
    if isinstance(state, FusedDIState):
        return restir_di_fused.step_fused(scene, state, cam, cfg)
    return step_general(scene, state, cam, cfg)


class Traced(NamedTuple):
    """A general frame after its per-pixel stage (`general_trace`)."""

    gb: gbuf.GBufferFrame
    direct: torch.Tensor  # [R, 3], accumulated (pending for DI)
    indirect: torch.Tensor  # [R, 3], accumulated
    di: Optional[restir_di.DirectStage]  # ReSTIR DI before its spatial pass
    gi_res: object  # the next GI reservoir


def general_gbuffer(scene: SceneTensors, state: RenderState, cam: Camera,
                    cfg: RenderConfig, pix0: int = 0, r=None):
    """Stage 1 of a general frame: the G-buffer pass of the frame, or of
    the row band of r pixels from global pixel pix0 -> (GBufferFrame,
    Interaction, SurfaceMaterial, ray_dir)."""
    return gbuf.render_gbuffer(scene, cam, state.last_camera, cfg,
                               state.looper & 0xFFFFFFFF, pix0, r)


def previous_packs(state: RenderState, cfg: RenderConfig) -> dict:
    """The previous frame's fields that `cfg`'s temporal gathers read at
    the motion index, as [C, R] channel packs: "di"
    (`restir_di.temporal_pack`), "gi" (the same for the GI reservoir, or
    the resolve pack itself) and "svgf" (`denoiser.svgf_pack`)."""
    out = {}
    temporal = bool(cfg.reuse & ReuseMode.TEMPORAL)
    if cfg.tracer in (TracerType.RESTIR_DI, TracerType.RESTIR_GI):
        if temporal:
            out["di"] = restir_di.temporal_pack(state.dir_reservoir,
                                                state.gbuffer)
        if cfg.tracer == TracerType.RESTIR_GI:
            if isinstance(state.gi_reservoir, torch.Tensor):
                out["gi"] = state.gi_reservoir
            elif temporal:
                out["gi"] = restir_di.temporal_pack(state.gi_reservoir,
                                                    state.gbuffer)
    if cfg.denoiser == DenoiserType.SVGF:
        out["svgf"] = dn.svgf_pack(state.denoiser, state.gbuffer)
    return out


def general_trace(scene: SceneTensors, state: RenderState, cam: Camera,
                  cfg: RenderConfig, primary, pix0: int = 0, prev=None,
                  prev_base: int = 0, r_prev=None) -> Traced:
    """Stage 2: each tracer's per-pixel work on stage 1's pixels (global
    pixels from pix0): ReSTIR DI up to its temporal merge, GI whole, the
    path tracers, the heatmap. `prev` maps `previous_packs`' names to
    their columns of global pixels prev_base .. of a previous frame of
    `r_prev` pixels (default: the state's own whole frame)."""
    looper = state.looper & 0xFFFFFFFF
    gb, it, mat, ray_dir = primary
    prev = prev or {}
    r = gb.depth.shape[0]
    direct, indirect = state.direct_illum, state.indirect_illum
    gi_res, di = state.gi_reservoir, None
    n = state.iteration
    if cfg.tracer in (TracerType.RESTIR_DI, TracerType.RESTIR_GI):
        di = restir_di.direct_temporal(
            scene, gb, state.gbuffer, it, mat, ray_dir, state.dir_reservoir,
            cfg, looper, pix0, prev.get("di"), prev_base)
        if cfg.tracer == TracerType.RESTIR_GI:
            # the DI + GI frame the reference sketches (main.cpp:167-168)
            ind, gi_res = restir_gi.restir_indirect(
                scene, gb, state.gbuffer, it, mat, ray_dir,
                state.gi_reservoir, cfg, looper, pix0, prev.get("gi"),
                prev_base, r_prev)
            indirect = _accumulate(indirect, ind, n, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_DIRECT:
        direct = _accumulate(direct, pt_direct(scene, cam, cfg, looper, pix0,
                                               r), n, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_INDIRECT:
        indirect = _accumulate(indirect, pt_indirect(scene, cam, cfg, looper,
                                                     pix0, r),
                               n, cfg.accumulate)
    elif cfg.tracer == TracerType.PT_FULL:
        d, ind = pt_trace(scene, cam, cfg, looper, pix0, r)
        direct = _accumulate(direct, d, n, cfg.accumulate)
        indirect = _accumulate(indirect, ind, n, cfg.accumulate)
    elif cfg.tracer == TracerType.BVH_VISUALIZE:
        count = bvh_heatmap(scene, cam, cfg, pix0, r).to(torch.float32)
        direct = torch.stack([count * 0.01] * 3, dim=-1)
    elif cfg.tracer != TracerType.GBUFFER_PREVIEW:
        raise ValueError(f"unknown tracer {cfg.tracer}")
    return Traced(gb=gb, direct=direct, indirect=indirect, di=di,
                  gi_res=gi_res)


def preview_peak(gb: gbuf.GBufferFrame, cfg: RenderConfig):
    """The maximum a GBUFFER_PREVIEW channel normalises by (depth,
    position; None for the others): a row band's, which the frame's is
    the maximum of."""
    if cfg.tracer != TracerType.GBUFFER_PREVIEW:
        return None
    if cfg.gbuffer_channel == "depth":
        return gb.depth.max()
    if cfg.gbuffer_channel == "position":
        return torch.abs(gb.pos).max()
    return None


def general_shade(state: RenderState, cfg: RenderConfig, tr: Traced,
                  img=None, row0: int = 0, peak=None):
    """Stage 3: ReSTIR DI's spatial merge (`img` / `row0` as in
    `restir_di.direct_shade`) and shade, or the G-buffer preview (`peak`:
    the frame's `preview_peak`, by default stage 1's own) -> (direct,
    indirect, the frame before the denoiser)."""
    gb, direct = tr.gb, tr.direct
    if tr.di is not None:
        out = restir_di.direct_shade(tr.di, gb, cfg,
                                     state.looper & 0xFFFFFFFF, img, row0)
        direct = _accumulate(direct, out, state.iteration, cfg.accumulate)
    elif cfg.tracer == TracerType.GBUFFER_PREVIEW:
        # channel previews (preview.cpp:253-287)
        if peak is None:
            peak = preview_peak(gb, cfg)
        if cfg.gbuffer_channel == "albedo":
            direct = gb.albedo
        elif cfg.gbuffer_channel == "depth":
            d = gb.depth / torch.clamp(peak, min=1e-6)
            direct = torch.stack([d] * 3, dim=-1)
        elif cfg.gbuffer_channel == "position":
            direct = torch.abs(gb.pos) / torch.clamp(peak, min=1e-6)
        else:
            direct = gb.norm * 0.5 + 0.5
    return direct, tr.indirect, direct + tr.indirect


def next_general_state(state: RenderState, cam: Camera, tr: Traced, direct,
                       indirect, den_state) -> RenderState:
    looper = state.looper & 0xFFFFFFFF
    return state._replace(
        looper=(looper + 1) & 0xFFFFFFFF, iteration=state.iteration + 1,
        direct_illum=direct, indirect_illum=indirect,
        dir_reservoir=(state.dir_reservoir if tr.di is None
                       else tr.di.res_out),
        gi_reservoir=tr.gi_res, gbuffer=tr.gb, last_camera=_copy_camera(cam),
        denoiser=den_state)


def step_general(scene: SceneTensors, state: RenderState, cam: Camera,
                 cfg: RenderConfig):
    """The general frame: stages 1-3 (`general_gbuffer`, `general_trace`,
    `general_shade`), then the denoiser, on the whole frame.
    `restir_tpu_torch.parallel.make_sharded_step` runs the same stages on
    row bands."""
    primary = general_gbuffer(scene, state, cam, cfg)
    tr = general_trace(scene, state, cam, cfg, primary)
    direct, indirect, frame = general_shade(state, cfg, tr)
    # denoise (the JAX package wires the reference's dormant filters)
    (frame,), (den_state,) = dn.denoise([frame], [tr.gb], [state.gbuffer],
                                        [state.denoiser], cfg)
    return next_general_state(state, cam, tr, direct, indirect,
                              den_state), frame


def render(scene: SceneTensors, cam: Camera, cfg: RenderConfig,
           num_frames: int, state=None, camera_fn=None, *, device="cuda"):
    """Run `num_frames` steps (mainLoop semantics); `camera_fn(i)` animates
    the camera. Returns (state, last frame); with no frames the frame is
    zero, [3, R] for a fused state and [R, 3] for a general one."""
    if state is None:
        state = init_state(cfg, cam, scene, device=device)
    r = cfg.num_pixels
    if isinstance(state, FusedDIState):
        frame = torch.zeros((3, r), device=state.accum.device)
    else:
        frame = torch.zeros((r, 3), device=state.direct_illum.device)
    for i in range(num_frames):
        c = camera_fn(i) if camera_fn is not None else cam
        state, frame = step(scene, state, c, cfg)
    return state, frame


def frame_to_image(frame: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Tonemap + quantise a frame to uint8 [H, W, 3] on its device: a
    general [R, 3] frame or a fused [3, R] one."""
    img = to_uint8(tonemap(frame, cfg.tone_mapping))
    if tuple(frame.shape) == (cfg.num_pixels, 3):
        return img.reshape(cfg.height, cfg.width, 3)
    return img.reshape(3, cfg.height, cfg.width).permute(1, 2, 0)


def _to_numpy(state):
    if isinstance(state, FusedDIState):
        return convert.state_to_numpy(state)
    return convert.render_state_to_numpy(state)


def save_checkpoint(path: str, state) -> None:
    """Write the state's leaves as `restir_tpu.renderer.save_checkpoint`
    does, so either package reads the file."""
    np.savez(path, *_to_numpy(state))


def load_checkpoint(path: str, cfg: RenderConfig, cam: Camera,
                    scene: Optional[SceneTensors] = None, *, device="cuda"):
    """Read a checkpoint written by this package or by
    `restir_tpu.renderer.save_checkpoint`; the state kind follows
    `init_state(cfg, cam, scene)`."""
    state0 = init_state(cfg, cam, scene, device="cpu")
    template = _to_numpy(state0)
    with np.load(path) as data:
        loaded = [data[f"arr_{i}"] for i in range(len(template))]
    for ref, got in zip(template, loaded):
        if tuple(np.shape(ref)) != tuple(got.shape):
            raise ValueError(
                f"checkpoint shape mismatch: {got.shape} vs "
                f"{np.shape(ref)} (different resolution or config?)")
    if isinstance(state0, FusedDIState):
        return convert.state_from_numpy(loaded, cfg, device)
    return convert.render_state_from_numpy(loaded, device)
