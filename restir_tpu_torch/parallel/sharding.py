"""Row-band rendering over a list of devices: the mesh, the scene, and the
general pipeline in bands (`shard_state`, `make_sharded_step`).

The port of `restir_tpu.parallel.sharding`. The JAX package is single-
controller: one process builds a 1-D `Mesh` over its devices and jits
the frame step with the state's `[R, ...]` leaves sharded on a pixel
axis, and XLA partitions the step into row bands and places the
collectives. Its counterpart here is one Python process that holds one
band per entry of an ordered device list (the "mesh") and copies pixel
ranges between the bands' devices (`Tensor.to(device,
non_blocking=True)`: a peer copy between two cards of one host). No
`torch.distributed` process group is involved, so the code runs
unchanged on one card with several bands, on the CPU, or on a host with
several cards. A mesh may name one device more than once.

The scene is read-only and every ray needs all of it, so it is
replicated: one copy per distinct device of the mesh (`shard_scene`).

The general step in bands (`make_sharded_step`) spells out what XLA
gives the JAX step, so that its frames are the single-device
`renderer.step_general`'s:
- every draw is keyed by the global pixel index (each band passes its
  first pixel, pix0, down to the G-buffer, the tracers, B8, B9 and B10);
- the temporal gathers (ReSTIR DI and GI, SVGF's history) read the
  previous frame wherever the motion points: each frame reads every
  band's [min, max] valid motion index to the host (one read for all
  bands) and fetches that range of the previous frame's fields from the
  bands that hold it, so the result is exact for any camera motion;
- ReSTIR DI's spatial merge runs after every band's temporal merge, on
  the band's rows of post-temporal reservoirs with ceil(spatial_radius)
  rows of its neighbours' (the frame's shared offsets move at most that
  far);
- the denoisers run `denoiser.denoise`, the single-device sequence, on
  the bands: its unchanged kernels (B3; the variance kernels and B4) run
  on each band's rows with the rows their taps reach (`band_images`,
  `denoise_halo_rows`), and it keeps the band's rows;
- GBUFFER_PREVIEW normalises by the maximum over all bands.
Bands hold H / n whole rows: a height that n does not divide is refused
(the JAX docstring asks for the same divisibility; XLA's ragged split is
not copied). With the GI resolve pack ([Q_CH, R], banded on its pixel
dimension) each band must also be whole 1024-pixel B9 tiles.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .. import renderer
from ..config import DenoiserType, RenderConfig, ReuseMode, TracerType
from ..models import denoiser as dn
from ..models import restir_di
from ..models.restir_di_fused import FusedDIState
from ..ops import reservoir as rsv
from ..ops.camera import Camera
from ..ops.kernels.gi import TILE as GI_TILE
from ..ops.kernels.tables import LazyWalkTables
from ..renderer import RenderState
from ..scene.scene_data import SceneTensors

PIXEL_AXIS = "pixels"  # the JAX mesh's axis name: row bands of pixels


def make_mesh(devices: Sequence = None) -> List[torch.device]:
    """The ordered device list that row bands map onto, one band per
    entry. Defaults to every CUDA device; it never falls back to the
    CPU, which must be asked for by name (`make_mesh(["cpu"] * 2)`)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; name the devices to use, e.g. "
                "make_mesh(['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: the device list is empty")
    return mesh


def _to(x, device):
    """A scene leaf on `device`: tensors copied, NamedTuples of tables
    walked, the lazy walk tables rebuilt there on first use."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, LazyWalkTables):
        return LazyWalkTables(x._arrays, x._verts.to(device))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def scene_to(scene: SceneTensors, device) -> SceneTensors:
    """`scene` with every table on `device` (the scene itself if it is
    there already)."""
    device = torch.device(device)
    if scene.tri_xform.device == device:
        return scene
    return _to(scene, device)


def shard_scene(scene: SceneTensors,
                mesh: Sequence[torch.device]) -> Dict[torch.device,
                                                      SceneTensors]:
    """Replicate the read-only scene: one `SceneTensors` per distinct
    device of the mesh, keyed by the device."""
    out = {}
    for d in mesh:
        if d not in out:
            out[d] = scene_to(scene, d)
    return out


def scene_on(scenes, device) -> SceneTensors:
    """The replica of `scenes` (`shard_scene`'s mapping, or one
    `SceneTensors`) on `device`."""
    if isinstance(scenes, SceneTensors):
        if scenes.tri_xform.device != device:
            raise ValueError(f"the scene is on {scenes.tri_xform.device}, "
                             f"a band on {device}: pass shard_scene's "
                             f"replicas")
        return scenes
    if device not in scenes:
        raise ValueError(f"no scene replica on {device}")
    return scenes[device]



# ---------------------------------------------------------------------------
# copies between bands


def _pixels(bands: Sequence[torch.Tensor], r_loc: int, lo: int, hi: int,
            device) -> torch.Tensor:
    """[C, hi - lo] global pixels lo..hi of the frame held by `bands`
    (band b holds [b r_loc, (b + 1) r_loc)), zeros outside the frame,
    on `device`: every band the range reaches sends its slice."""
    r = r_loc * len(bands)
    c = bands[0].shape[0]
    parts = []
    if lo < 0:
        parts.append(torch.zeros((c, min(hi, 0) - lo), dtype=torch.float32,
                                 device=device))
    for b in range(len(bands)):
        a, e = max(lo, b * r_loc), min(hi, (b + 1) * r_loc)
        if a < e:
            parts.append(bands[b][:, a - b * r_loc:e - b * r_loc].to(
                device, non_blocking=True))
    if hi > r:
        parts.append(torch.zeros((c, hi - max(lo, r)), dtype=torch.float32,
                                 device=device))
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, 1)


def haloed(bands: Sequence[torch.Tensor], b: int, h: int, device):
    """Band b with +-h pixels of its neighbours (h <= r_loc: ppermute's
    nearest-neighbour halos; zeros past the frame's ends)."""
    r_loc = bands[b].shape[1]
    return _pixels(bands, r_loc, b * r_loc - h, (b + 1) * r_loc + h, device)


def denoise_halo_rows(cfg: RenderConfig) -> int:
    """Rows above and below a band that its denoiser chain reads: the
    5x5 à-trous taps at stride 2^l reach 2^(l+1) rows per level, and
    SVGF adds its variance estimate and one 3x3 prefilter per level."""
    rows = 2 * ((1 << cfg.eaw_levels) - 1)
    if cfg.denoiser == DenoiserType.SVGF:
        rows += 1 + cfg.eaw_levels
    return rows


def row_image(bands: Sequence[torch.Tensor], b: int, halo: int, width: int,
              height: int, device):
    """The rows band b touches with `halo` rows above and below (cut at
    the frame's edges), gathered from every band that holds them as one
    [C, rows x W] image on `device` -> (image, rows, the image's first
    global row)."""
    r_loc = bands[b].shape[1]
    y0, y1 = b * r_loc // width, ((b + 1) * r_loc - 1) // width + 1
    ya, yb = max(y0 - halo, 0), min(y1 + halo, height)
    return _pixels(bands, r_loc, ya * width, yb * width, device), yb - ya, ya


def band_images(mesh: Sequence[torch.device], halo: int, width: int,
                height: int):
    """The denoisers' image provider for row bands over `mesh`
    (`denoiser.eaw_filter`): image(planes, b) -> band b's `row_image` with
    `halo` rows of each list of band planes, the image's height and the
    band's first pixel in it."""
    def image(planes, b):
        imgs = [row_image(p, b, halo, width, height, mesh[b]) for p in planes]
        r_loc = planes[0][b].shape[1]
        return ([i[0] for i in imgs], imgs[0][1],
                b * r_loc - imgs[0][2] * width)

    return image


def gather(x, device, dim=1):
    """Join band tensors (in mesh order) into one tensor on `device`, the
    counterpart of `np.asarray` on a sharded JAX array: the fused path's
    [C, r_loc] packs along dim 1, the general frame's [r_loc, 3] bands
    with dim=0. A `FusedDIState` gathers every banded pack, and its other
    tensors move to `device` (a banded general state: `gather_state`)."""
    if isinstance(x, FusedDIState):
        return x._replace(**{
            f: gather(v, device) if isinstance(v, (list, tuple))
            else v.to(device)
            for f, v in x._asdict().items()
            if isinstance(v, (list, tuple, torch.Tensor))
            and f != "last_camera"})
    return torch.cat([t.to(device) for t in x], dim=dim)


def motion_ranges(gbs, r_total: int, device) -> List[tuple]:
    """Per band, the global pixels [lo, hi) of the previous frame that its
    valid motion indices reach (`restir_di.motion_valid`; (0, 1) when it
    has none), read to the host once for all bands."""
    pairs = []
    for gb in gbs:
        valid = restir_di.motion_valid(gb)
        pairs.append(torch.stack([
            torch.where(valid, gb.motion, r_total).amin(),
            torch.where(valid, gb.motion, -1).amax()]).to(device))
    return [(lo, hi + 1) if hi >= lo else (0, 1)
            for lo, hi in torch.stack(pairs).tolist()]


def fetch_columns(packs: Sequence[dict], r_loc: int, lo: int, hi: int,
                  device) -> dict:
    """Each named pack's global pixels [lo, hi), from every band's
    `renderer.previous_packs` that holds them, on `device`."""
    return {k: _pixels([p[k] for p in packs], r_loc, lo, hi, device)
            for k in packs[0]}


# ---------------------------------------------------------------------------
# the general state in bands

_REPLICATED = ("looper", "iteration", "last_camera")


def general_layout(cfg: RenderConfig, n: int, resolve_pack=False) -> int:
    """The pixels of each of n row bands of cfg's frame: H / n whole
    rows; with the GI resolve pack also whole B9 tiles."""
    if n < 1 or cfg.height % n:
        raise ValueError(f"row bands hold whole rows: the height "
                         f"{cfg.height} is not divisible by the {n} bands "
                         f"(H % n != 0)")
    r_loc = cfg.num_pixels // n
    if resolve_pack and r_loc % GI_TILE:
        raise ValueError(f"the GI resolve pack (B9) works on whole "
                         f"{GI_TILE}-pixel tiles: a band of {r_loc} pixels "
                         f"({cfg.height // n} rows of {cfg.width}) is not")
    return r_loc


def _refuse_fused(state):
    if isinstance(state, FusedDIState):
        raise TypeError("a FusedDIState renders in row bands through "
                        "shard_fused_state / make_fused_sharded_step; "
                        "shard_state / make_sharded_step take the general "
                        "RenderState")


def _resolve_pack(gi_reservoir) -> bool:
    return isinstance(gi_reservoir, (torch.Tensor, list))


def shard_state(state: RenderState, mesh: Sequence[torch.device],
                cfg: RenderConfig) -> RenderState:
    """Split every [R, ...] leaf of a general state into row bands along
    its pixel dimension (dim 0; the GI resolve pack's dim 1), band b on
    `mesh[b]`: each leaf becomes the list of its bands. The looper,
    iteration and camera stay as they are (the JAX step replicates
    them)."""
    _refuse_fused(state)
    mesh = list(mesh)
    r_loc = general_layout(cfg, len(mesh), _resolve_pack(state.gi_reservoir))

    def split(dim):
        return lambda t: [t.narrow(dim, b * r_loc, r_loc).to(d).contiguous()
                          for b, d in enumerate(mesh)]

    return state._replace(**{
        f: rsv.tree_map(split(1 if f == "gi_reservoir"
                              and _resolve_pack(v) else 0), v)
        for f, v in state._asdict().items() if f not in _REPLICATED})


def gather_state(state: RenderState, device) -> RenderState:
    """Join a banded general state (`shard_state`'s) into one on
    `device`."""
    def join(dim):
        return lambda parts: torch.cat([t.to(device) for t in parts], dim)

    return state._replace(**{
        f: (join(1)(v) if f == "gi_reservoir" and _resolve_pack(v)
            else rsv.tree_map(join(0), v))
        for f, v in state._asdict().items() if f not in _REPLICATED})


def band_state(state: RenderState, b: int) -> RenderState:
    """Band b of a banded general state, as a state of its pixels."""
    return state._replace(**{
        f: (v[b] if isinstance(v, list) else
            rsv.tree_map(lambda parts: parts[b], v))
        for f, v in state._asdict().items() if f not in _REPLICATED})


def _join_bands(states: Sequence[RenderState]) -> RenderState:
    first = states[0]
    return first._replace(**{
        f: (list(vs) if isinstance(vs[0], torch.Tensor) else
            rsv.tree_map(lambda *parts: list(parts), *vs))
        for f, vs in zip(first._fields, zip(*states))
        if f not in _REPLICATED})


def make_sharded_step(cfg: RenderConfig, mesh: Sequence[torch.device],
                      template_state: RenderState):
    """fn(scenes, state, cam) -> (state', frame) running the general
    frame (`renderer.step_general`, every tracer and denoiser it carries)
    with the state in row bands over `mesh` (one band per entry).
    `scenes` is `shard_scene(scene, mesh)` (or one `SceneTensors` when the
    mesh names a single device), `state` is `shard_state(...)` of a state
    shaped as `template_state`, and the frame is a list of [r_loc, 3]
    band tensors (`gather(frame, device, dim=0)` joins them). The step
    runs in stages, with the copies between them:
    1. every band's G-buffer; the bands' motion ranges to the host;
    2. every band's tracer work against the fetched ranges of the
       previous frame (ReSTIR DI to its temporal merge, GI whole);
    3. ReSTIR DI's spatial merge on row-haloed post-temporal reservoirs
       and its shade, or the preview under the frames' maximum;
    4. the denoiser on row-haloed band images."""
    _refuse_fused(template_state)
    mesh = list(mesh)
    n = len(mesh)
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    r_loc = general_layout(
        cfg, n, cfg.tracer == TracerType.RESTIR_GI
        and _resolve_pack(template_state.gi_reservoir))
    spatial = (cfg.tracer in (TracerType.RESTIR_DI, TracerType.RESTIR_GI)
               and bool(cfg.reuse & ReuseMode.SPATIAL))
    halo_s = int(math.ceil(cfg.spatial_radius))
    images = band_images(mesh, denoise_halo_rows(cfg), w, h)

    def step(scenes, state: RenderState, cam: Camera):
        bands = [band_state(state, b) for b in range(n)]
        scene_of = [scene_on(scenes, d) for d in mesh]
        pix0 = [b * r_loc for b in range(n)]
        # 1. G-buffers, and the previous frame's pixels each band's
        # motion reaches
        primary = [renderer.general_gbuffer(scene_of[b], bands[b], cam, cfg,
                                            pix0[b], r_loc)
                   for b in range(n)]
        packs = [renderer.previous_packs(s, cfg) for s in bands]
        ranges = ([(0, 1)] * n if not packs[0] else
                  motion_ranges([p[0] for p in primary], r, mesh[0]))
        fetched = [fetch_columns(packs, r_loc, lo, hi, d)
                   for (lo, hi), d in zip(ranges, mesh)]
        # 2. each tracer's per-pixel work
        traced = [renderer.general_trace(
            scene_of[b], bands[b], cam, cfg, primary[b], pix0[b],
            fetched[b], ranges[b][0], r) for b in range(n)]
        # 3. spatial merge and shade
        peak = [renderer.preview_peak(t.gb, cfg) for t in traced]
        if peak[0] is not None:
            top = torch.stack([p.to(mesh[0]) for p in peak]).max()
            peak = [top.to(d) for d in mesh]
        sp = ([restir_di.spatial_pack(t.di.res_out, t.gb) for t in traced]
              if spatial else None)
        shaded = []
        for b, d in enumerate(mesh):
            img, row0 = None, 0
            if sp is not None:
                img, rows, row0 = row_image(sp, b, halo_s, w, h, d)
                img = img.reshape(img.shape[0], rows, w)
            shaded.append(renderer.general_shade(bands[b], cfg, traced[b],
                                                 img, row0, peak[b]))
        # 4. the denoiser
        frames, dens = dn.denoise(
            [s[2] for s in shaded], [t.gb for t in traced],
            [s.gbuffer for s in bands], [s.denoiser for s in bands], cfg,
            images, [(f.get("svgf"), lo) for f, (lo, _) in zip(fetched,
                                                                ranges)])
        nxt = [renderer.next_general_state(bands[b], cam, traced[b],
                                           shaded[b][0], shaded[b][1],
                                           dens[b]) for b in range(n)]
        return _join_bands(nxt), frames

    return step
