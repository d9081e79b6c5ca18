"""The fused ReSTIR DI frame over row bands, one band per mesh entry.

The port of `restir_tpu.parallel.fused_sharding`. The frame's R pixels
split into n contiguous bands of r_loc = R / n pixels (whole 1024-pixel
tiles; a band may start and end mid-row), band b on device `mesh[b]`
starting at global pixel pix0 = b * r_loc. Every pack of the state and
the frame is a list of band tensors [C, r_loc] in mesh order. Per band
the step runs the kernels the JAX step runs under `shard_map`, with the
band arguments that keep its random streams and tile offsets those of a
single-device frame:

- B6 (`gbuffer.gbuffer_pack`, pix0): the band's G-buffer;
- B7 + B1b (`reuse.reuse`, pix0, prev_base = pix0 - window): RIS, the
  winner's shadow ray and the temporal merge against the previous pt
  pack with +-window halos from the neighbouring bands;
- B2 (`spatial.spatial_shade`, pix0, halo_s, r_total = R): the spatial
  merge against the new pt pack with +-halo_s halos, shading and the
  running mean;
- with SVGF, B5 (`svgf.svgf_temporal`, prev_base, window) on the svgf
  pack with +-window halos.

A halo exchange has `jax.lax.ppermute`'s semantics: the first band's low
halo and the last band's high halo are zeros. Slices cross to the
receiving band's device with `Tensor.to(device, non_blocking=True)`.

The denoiser runs the port's own kernels on row-haloed band images
(`sharding.band_images`), where the JAX step runs XLA plane ops under
the sharding: B3 for EAW (`eaw_filter_packed` on each band's image);
for SVGF the single-device sequence `svgf_filter_packed` on the bands
(B5, the variance estimate, then per level its prefilter and B4). A
band's image is the rows it touches plus the rows the whole chain's taps
reach (2 (1 + 2 + ... + 2^(L-1)) for L EAW levels; 1 + L more for SVGF's
3x3 passes), gathered from every band that holds them and cut at the
frame's edges; the band's pixels are cropped from the result, which
equals the single-device chain's bit for bit. The kernels are unchanged:
a haloed band is a shorter image.

The JAX step silently renders DI only under RESTIR_GI (its `accum_ind`
passes through); this step refuses RESTIR_GI instead, and every config
the fused gate refuses. Like the JAX step it takes the resident path
only (at most 1024 triangles), but with the port's B6 / B7 on every
band, so a one-band mesh renders what `renderer.step`'s B1 renders.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..config import DenoiserType, RenderConfig, ReuseMode, TracerType
from ..models import restir_di_fused as fused
from ..models.restir_di_fused import FusedDIState
from ..ops.camera import Camera, pack_camera
from ..ops.kernels import gbuffer, reuse, spatial
from ..ops.kernels.fused_di import TILE, WINDOW
from .sharding import band_images, denoise_halo_rows, haloed, scene_on


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_layout(cfg: RenderConfig, n: int):
    """(r_loc, window, halo_s) of an n-band split of cfg's frame, with
    the JAX step's preconditions (fused_sharding.py:71-80)."""
    r = cfg.num_pixels
    if n < 1 or r % (n * TILE) != 0:
        raise ValueError(f"bands must be 1024-pixel aligned: R = {r} is not "
                         f"a multiple of {n} x {TILE}")
    r_loc = r // n
    window = min(WINDOW, r_loc)
    rad = int(math.ceil(cfg.spatial_radius))
    halo_s = min(_round_up((rad + 1) * cfg.width + 133, TILE), r_loc)
    return r_loc, window, halo_s


def refusal(cfg: RenderConfig):
    """Why the row-band step refuses `cfg` (None if it takes it)."""
    if cfg.tracer == TracerType.RESTIR_GI:
        return ("RESTIR_GI: the fused row-band step renders DI only (the JAX "
                "step silently drops GI, fused_sharding.py:182); GI renders "
                "in row bands through make_sharded_step on the general "
                "state")
    reason = fused.ineligibility(cfg)
    return None if reason is None else f"fused DI path: {reason}"


def shard_fused_state(state: FusedDIState,
                      mesh: Sequence[torch.device]) -> FusedDIState:
    """Split every [C, R] pack of a fused state into row bands, band b on
    `mesh[b]`; the looper, iteration, camera and [1, 1, 1] placeholders
    stay as they are (the JAX step replicates them)."""
    r = state.accum.shape[1]
    n = len(mesh)
    if r % n:
        raise ValueError(f"{r} pixels do not split into {n} bands")
    r_loc = r // n

    def split(v):
        if isinstance(v, torch.Tensor) and v.dim() == 2 and v.shape[1] == r:
            return [v[:, b * r_loc:(b + 1) * r_loc].to(d).contiguous()
                    for b, d in enumerate(mesh)]
        return v

    return state._replace(**{f: split(v) for f, v in state._asdict().items()
                             if f != "last_camera"})


def make_fused_sharded_step(cfg: RenderConfig,
                            mesh: Sequence[torch.device]):
    """fn(scenes, state, cam) -> (state', frame) running the fused DI
    frame with every pack in row bands over `mesh` (one band per entry).
    `scenes` is `shard_scene(scene, mesh)` (or one `SceneTensors` when the
    mesh names a single device), `state` is `shard_fused_state(...)`, and
    the frame is a list of [3, r_loc] band tensors. The step consumes the
    state, as the single-device step does: B2 updates the accumulator
    bands in place."""
    reason = refusal(cfg)
    if reason is not None:
        raise NotImplementedError(f"row bands: {reason}")
    mesh = list(mesh)
    n = len(mesh)
    w_img, h_img, r = cfg.width, cfg.height, cfg.num_pixels
    r_loc, window, halo_s = band_layout(cfg, n)
    kw = dict(k=cfg.cdf_candidates, single_sided=cfg.single_sided_lights,
              temporal=bool(cfg.reuse & ReuseMode.TEMPORAL),
              temporal_clamp=cfg.temporal_clamp,
              has_met=cfg.scene_has_metallic, has_env=cfg.has_env_map)

    images = band_images(mesh, denoise_halo_rows(cfg), w_img, h_img)

    def step(scenes, state: FusedDIState, cam: Camera):
        looper = state.looper & 0xFFFFFFFF
        devs = list(dict.fromkeys(mesh))
        cams = {d: (pack_camera(cam, d), pack_camera(state.last_camera, d))
                for d in devs}
        for d in devs:
            n_tris = scene_on(scenes, d).num_tris
            if n_tris > fused.RESIDENT_MAX_TRIS:
                raise ValueError(
                    f"sharded row bands need the resident path: {n_tris} "
                    f"triangles, over {fused.RESIDENT_MAX_TRIS} (ROADMAP "
                    "A9c)")

        gbs, pts = [], []
        for b, d in enumerate(mesh):
            scene = scene_on(scenes, d)
            pix0 = b * r_loc
            cv, lcv = cams[d]
            gb = gbuffer.gbuffer_pack(
                cv, lcv, looper, scene.bvh, width=w_img, height=h_img,
                aa_jitter=cfg.aa_jitter,
                single_sided=cfg.single_sided_lights,
                has_env=cfg.has_env_map, with_textures=cfg.with_textures,
                pix0=pix0, r=r_loc)
            prev_ext = haloed(state.pt_pack, b, window, d)
            pts.append(reuse.reuse(
                gb, prev_ext, looper, scene.tables, scene.bvh, width=w_img,
                pix0=pix0, prev_base=pix0 - window, window=window, **kw))
            gbs.append(gb)

        accum = []
        for b, d in enumerate(mesh):
            pix0 = b * r_loc
            offs = spatial.spatial_offsets(
                looper, r_loc, w_img, cfg.spatial_neighbors,
                cfg.spatial_radius, d, pix0=pix0, halo=halo_s, r_total=r)
            accum.append(spatial.spatial_shade(
                offs, gbs[b], pts[b], state.accum[b], looper,
                state.iteration, width=w_img, height=h_img,
                neighbors=cfg.spatial_neighbors, accumulate=cfg.accumulate,
                reuse_spatial=bool(cfg.reuse & ReuseMode.SPATIAL),
                has_met=cfg.scene_has_metallic,
                pt_ext=haloed(pts, b, halo_s, d), pix0=pix0))

        frame, svgf_pack = accum, state.svgf_pack
        if cfg.denoiser == DenoiserType.EAW:
            frame = []
            for b in range(n):
                (acc_img, gb_img), h, o = images([accum, gbs], b)
                out = fused.eaw_filter_packed(acc_img, gb_img,
                                              cfg.replace(height=h))
                frame.append(out[:, o:o + r_loc].contiguous())
        elif cfg.denoiser == DenoiserType.SVGF:
            frame, svgf_pack = fused.svgf_filter_packed(
                accum, gbs,
                [haloed(state.svgf_pack, b, window, d)
                 for b, d in enumerate(mesh)],
                cfg, images, [b * r_loc - window for b in range(n)], window)

        next_state = state._replace(
            looper=(looper + 1) & 0xFFFFFFFF,
            iteration=state.iteration + 1,
            accum=accum,
            pt_pack=pts,
            svgf_pack=svgf_pack,
            last_camera=fused._copy_camera(cam),
        )
        return next_state, frame

    return step
