"""Frame orchestration of the port, as `restir_tpu.renderer`.

This slice carries the fused ReSTIR DI state only: `init_state` returns
a `FusedDIState` when the config fits the ported path (any triangle
count, env maps and textures, the EAW or SVGF denoiser or none) and
raises `NotImplementedError` (naming the ROADMAP item) otherwise; there
is no general pipeline to fall back to yet. Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU.
"""

from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

from . import convert
from .config import RenderConfig, validate_mat_flags
from .models import restir_di_fused
from .models.restir_di_fused import FusedDIState
from .ops.camera import Camera
from .ops.tonemap import to_uint8, tonemap
from .scene.scene_data import SceneTensors


def _host_materials(scene: SceneTensors):
    """The two material arrays `config.mat_flags` reads, on the host."""
    return types.SimpleNamespace(mat_type=scene.mat_type.cpu().numpy(),
                                 mat_attr=scene.mat_attr.cpu().numpy())


def init_state(cfg: RenderConfig, cam: Camera,
               scene: Optional[SceneTensors] = None, *, device="cuda"):
    """Render state for `cfg` on `device`. With `scene`, also checks the
    config's material flags against the scene and the scene's size."""
    if scene is not None:
        validate_mat_flags(cfg, _host_materials(scene))
        if cfg.has_env_map and not scene.has_env_map:
            raise ValueError("RenderConfig has_env_map is set but the scene "
                             "has no env map")
    reason = restir_di_fused.ineligibility(cfg)
    if reason is not None:
        raise NotImplementedError(
            f"restir_tpu_torch renders the fused ReSTIR DI path only: "
            f"{reason}")
    return restir_di_fused.init_state(cfg, cam, device)


def reset_accumulation(state: FusedDIState) -> FusedDIState:
    """Camera-change reset: restart averaging and temporal history, keep
    the RNG epoch monotonic."""
    return restir_di_fused.reset_accumulation(state)


def step(scene: SceneTensors, state: FusedDIState, cam: Camera,
         cfg: RenderConfig):
    """One frame. Returns (next state, frame [3, R]). Consumes `state`
    (see `restir_di_fused.step_fused`)."""
    return restir_di_fused.step_fused(scene, state, cam, cfg)


def frame_to_image(frame: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Tonemap + quantize a [3, R] frame to uint8 [H, W, 3] (on the
    frame's device)."""
    img = to_uint8(tonemap(frame, cfg.tone_mapping))
    return img.reshape(3, cfg.height, cfg.width).permute(1, 2, 0)


def save_checkpoint(path: str, state: FusedDIState) -> None:
    """Write the state as `restir_tpu.renderer.save_checkpoint` does."""
    np.savez(path, *convert.state_to_numpy(state))


def load_checkpoint(path: str, cfg: RenderConfig, cam: Camera,
                    scene: Optional[SceneTensors] = None, *, device="cuda"):
    """Read a checkpoint of a fused DI state, written by this package or
    by `restir_tpu.renderer.save_checkpoint`."""
    template = convert.state_to_numpy(init_state(cfg, cam, scene,
                                                 device="cpu"))
    with np.load(path) as data:
        loaded = [data[f"arr_{i}"] for i in range(len(template))]
    for ref, got in zip(template, loaded):
        if tuple(np.shape(ref)) != tuple(got.shape):
            raise ValueError(
                f"checkpoint shape mismatch: {got.shape} vs "
                f"{np.shape(ref)} (different resolution or config?)")
    return convert.state_from_numpy(loaded, cfg, device)
