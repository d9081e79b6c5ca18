"""Carry the JAX package's data across to the port, through numpy.

- `scene_from_numpy`: the JAX `SceneData` leaves (as numpy, by field
  name; a port `SceneArrays` works too) -> the port's `SceneTensors`.
- `state_from_numpy` / `state_to_numpy`: a fused DI or DI + GI state as
  the leaf list that `restir_tpu.renderer.save_checkpoint` writes (the
  `FusedDIState` fields in order, the 8 `Camera` leaves last; packs as
  [C, R/128, 128], the SVGF pack, `accum_ind` and `gi_q` too, or
  [1, 1, 1] where the config has none) <-> the port's `FusedDIState`
  ([C, R] packs).
- `render_state_from_numpy` / `render_state_to_numpy`: the general
  `RenderState` as the same writer's leaf list (JAX flatten order: looper
  uint32, iteration int32, the two accumulators, both reservoirs, the
  G-buffer, the camera, the SVGF history; [R, ...] leaves as they are).
  The GI reservoir is either a `Reservoir` (7 leaves) or the [Q_CH, R]
  resolve pack (1 leaf); the leaf count tells which.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .config import RenderConfig
from .models.gbuffer import GBufferFrame
from .models.restir_di_fused import FusedDIState
from .ops import reservoir as rsv
from .ops.camera import Camera
from .ops.kernels.fused_di import PT_CH
from .ops.kernels.gi import Q_CH
from .ops.kernels.svgf import SV_CH
from .ops.kernels.tables import (
    LazyWalkTables,
    build_bvh_tables,
    build_resident_tables,
    has_env_map,
)
from .scene.scene_data import SceneTensors

N_STATE_LEAVES = 7 + len(Camera._fields)


def scene_from_numpy(d, device="cuda") -> SceneTensors:
    """SceneTensors (and its kernel tables) on `device` from numpy
    scene arrays keyed by the JAX `SceneData` field names. The exact
    MTBVH walk's tables (`scene.walk`) are built on first use, so a run
    that never takes the walk pays nothing for them."""
    if not isinstance(d, Mapping):
        d = d._asdict()

    def dev(name, dtype=torch.float32):
        return torch.tensor(np.asarray(d[name]), dtype=dtype,
                            device=device)

    tables = build_resident_tables(d, device)
    verts = dev("verts")
    maps = np.asarray(d["mat_attr"])[:, 7:11]  # base/metal/rough/normal
    return SceneTensors(
        tri_xform=dev("tri_xform"),
        prim_attr=dev("prim_attr"),
        mat_attr=dev("mat_attr"),
        mat_type=dev("mat_type", torch.int32),
        light_verts=dev("light_verts"),
        light_normal=dev("light_normal"),
        light_radiance=dev("light_radiance"),
        light_area=dev("light_area"),
        light_center=dev("light_center"),
        light_radius=dev("light_radius"),
        tables=tables,
        bvh=build_bvh_tables(d, tables, device),
        walk=LazyWalkTables(d, verts),
        has_env_map=has_env_map(d),
        has_textures=bool((maps >= 0).any()),
        verts=verts,
        **{name: dev(name) for name in _GENERAL_F32},
        **{name: dev(name, torch.int32) for name in _GENERAL_I32},
    )


# the SceneData leaves the general path reads, beside the kernel tables
_GENERAL_F32 = (
    "norms", "uvs", "light_prob", "sum_light_power_inv", "env_map",
    "env_prob", "env_tile_rad", "env_tile_uv", "env_tile_sa", "tex_data",
    "mat_base_color", "mat_metallic", "mat_roughness", "mat_ior")
_GENERAL_I32 = (
    "mat_ids", "light_prim_ids", "light_alias", "env_alias", "tex_offset",
    "tex_width", "tex_height", "mat_base_map", "mat_metallic_map",
    "mat_roughness_map", "mat_normal_map")


def camera_from_numpy(leaves: Sequence[np.ndarray]) -> Camera:
    return Camera(*(torch.tensor(np.asarray(x, np.float32))
                    for x in leaves))


def camera_to_numpy(cam: Camera):
    return [np.asarray(torch.as_tensor(x).cpu(), np.float32) for x in cam]


def _pack(a, channels: int, r: int, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.size != channels * r:
        raise ValueError(f"pack of shape {a.shape} is not [{channels}, {r}]")
    return torch.as_tensor(a.reshape(channels, r).copy(), device=device)


def state_from_numpy(leaves: Sequence[np.ndarray], cfg: RenderConfig,
                     device="cuda") -> FusedDIState:
    """Port state from the leaves of a JAX `FusedDIState` (DI or DI + GI,
    with or without SVGF)."""
    if len(leaves) != N_STATE_LEAVES:
        raise ValueError(f"expected {N_STATE_LEAVES} leaves, got "
                         f"{len(leaves)}")
    r = cfg.num_pixels
    looper, iteration, accum, pt, svgf, accum_ind, gi_q = leaves[:7]

    def optional(x, channels):
        """A [channels, R] pack, or the [1, 1, 1] placeholder."""
        if np.asarray(x).size == 1:
            return torch.tensor(np.asarray(x, np.float32).reshape(1, 1, 1),
                                device=device)
        return _pack(x, channels, r, device)

    return FusedDIState(
        looper=int(np.asarray(looper).astype(np.uint32)),
        iteration=int(np.asarray(iteration)),
        accum=_pack(accum, 3, r, device),
        pt_pack=_pack(pt, PT_CH, r, device),
        svgf_pack=optional(svgf, SV_CH),
        accum_ind=optional(accum_ind, 3),
        gi_q=optional(gi_q, Q_CH),
        last_camera=camera_from_numpy(leaves[7:]),
    )


def state_to_numpy(state: FusedDIState):
    """Leaf list in the JAX `FusedDIState` order and shapes."""
    r = state.accum.shape[1]

    def pack(t):
        return t.detach().cpu().numpy().reshape(t.shape[0], r // 128, 128)

    def small(t):
        return t.detach().cpu().numpy().reshape(1, 1, 1)

    def optional(t):
        return (small if t.numel() == 1 else pack)(t)

    return [
        np.uint32(state.looper & 0xFFFFFFFF),
        np.int32(state.iteration),
        pack(state.accum),
        pack(state.pt_pack),
        optional(state.svgf_pack),
        optional(state.accum_ind),
        optional(state.gi_q),
        *camera_to_numpy(state.last_camera),
    ]


def _render_state_template(gi_pack: bool = False):
    """A RenderState skeleton whose leaves are placeholders; `gi_pack`
    makes the GI reservoir the one-leaf resolve pack."""
    from .renderer import RenderState, SVGFState

    def tup(cls):
        return cls(*([None] * len(cls._fields)))

    return RenderState(
        looper=None, iteration=None, direct_illum=None, indirect_illum=None,
        dir_reservoir=rsv.Reservoir(tup(rsv.DirectSample), None, None),
        gi_reservoir=(None if gi_pack else
                      rsv.Reservoir(tup(rsv.IndirectSample), None, None)),
        gbuffer=tup(GBufferFrame), last_camera=tup(Camera),
        denoiser=tup(SVGFState))


def render_state_to_numpy(state):
    """Leaf list of a general RenderState in the JAX flatten order."""
    cam = Camera(*camera_to_numpy(state.last_camera))
    leaves = rsv.tree_leaves(state._replace(last_camera=cam))[2:]
    return [np.uint32(state.looper & 0xFFFFFFFF), np.int32(state.iteration),
            *(x if isinstance(x, np.ndarray) else x.detach().cpu().numpy()
              for x in leaves)]


def render_state_from_numpy(leaves: Sequence[np.ndarray], device="cuda"):
    """A general RenderState from the JAX writer's leaf list."""
    counts = {len(rsv.tree_leaves(_render_state_template(p))): p
              for p in (False, True)}
    if len(leaves) not in counts:
        raise ValueError(f"expected {' or '.join(map(str, counts))} leaves, "
                         f"got {len(leaves)}")
    template = _render_state_template(counts[len(leaves)])
    state = rsv.tree_unflatten(template, [
        torch.as_tensor(np.array(x), device=device) for x in leaves])
    return state._replace(
        looper=int(np.asarray(leaves[0]).astype(np.uint32)),
        iteration=int(np.asarray(leaves[1])),
        last_camera=camera_from_numpy([x.cpu().numpy()
                                       for x in state.last_camera]))
