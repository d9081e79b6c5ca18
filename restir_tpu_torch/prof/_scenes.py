"""The scenes and frame inputs the probes share: the headline scene
(many_light_scene(64, 24)), scenes/hall.txt (81,036 triangles) and the
hall under a code-made sky, at 1920x1080 with chip_smoke.py's cameras;
with `small`, tiny stand-ins at 128x16 whose plain twins run on the CPU in
seconds (many_light_scene(4, 2); for the hall many_light_scene(4, 90),
1,098 triangles: the streaming route)."""

from __future__ import annotations

import functools
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from .. import convert
from ..config import RenderConfig, TracerType, mat_flags
from ..ops.camera import make_camera, pack_camera
from ..ops.kernels import gbuffer
from ..scene.loader import parse_scene_file
from ..scene.procedural import gradient_sky, many_light_scene

REPO = Path(__file__).resolve().parents[2]
FULL = (1920, 1080)
SMALL = (128, 16)
# the moved camera of the hall's frame 1 (chip_smoke.py phase 9)
HALL_CAM2 = dict(position=(0.3, 4.2, 20.3), rotation=(-90.5, -4.0, 0.0),
                 fov_y=19.5)


class Frame(NamedTuple):
    name: str
    arrays: object  # SceneArrays (host)
    scene: object  # SceneTensors on the device
    cfg: RenderConfig
    cam: object  # frame 0's camera
    cam2: object  # frame 1's camera

    @property
    def device(self):
        return self.scene.verts.device

    def gkw(self):
        """B6's keyword arguments for this frame."""
        c = self.cfg
        return dict(width=c.width, height=c.height, aa_jitter=c.aa_jitter,
                    single_sided=c.single_sided_lights, has_env=c.has_env_map,
                    with_textures=c.with_textures)

    def rkw(self):
        """B7's candidate keyword arguments for this frame."""
        c = self.cfg
        return dict(k=c.cdf_candidates, single_sided=c.single_sided_lights,
                    has_met=c.scene_has_metallic, has_env=c.has_env_map)

    def cams(self):
        dev = self.device
        return pack_camera(self.cam, dev), pack_camera(self.cam2, dev)


def _frame(name, arrays, cam, cam2, device, size, **cfg_kw):
    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       **mat_flags(arrays), **cfg_kw)
    return Frame(name, arrays, convert.scene_from_numpy(arrays, device), cfg,
                 cam, cam2)


@functools.lru_cache(maxsize=8)
def _cached(kind, device, small, sky):
    return (_headline(device, small) if kind == "headline"
            else _hall(device, small, sky))


def headline(device, small=False) -> Frame:
    """The headline scene (built once per device and size)."""
    return _cached("headline", str(torch.device(device)), small, False)


def hall(device, small=False, sky=False) -> Frame:
    """scenes/hall.txt (`sky`: under gradient_sky(512, 1024)); with
    `small` the stand-in scene, with an env map for `sky` (built once per
    device, size and sky)."""
    return _cached("hall", str(torch.device(device)), small, sky)


def _headline(device, small=False) -> Frame:
    arrays, camkw = many_light_scene(4, 2) if small else many_light_scene(
        64, 24)
    cam = make_camera(**camkw)
    return _frame("headline", arrays, cam, cam, device,
                  SMALL if small else FULL)


def _hall(device, small=False, sky=False) -> Frame:
    name = "sky_hall" if sky else "hall"
    if small:  # over RESIDENT_MAX_TRIS: the streaming route, as the hall
        arrays, camkw = many_light_scene(4, 90)
        if sky:
            from ..scene.procedural import env_scene
            arrays, camkw = env_scene()
        cam = make_camera(**camkw)
        return _frame(name, arrays, cam, cam, device, SMALL,
                      has_env_map=sky)
    sys.path.insert(0, str(REPO / "scenes"))
    from make_hall import ensure_assets  # numpy only: scenes/generated

    ensure_assets()
    sf = parse_scene_file(str(REPO / "scenes" / "hall.txt"))
    if sky:
        sf.env_map = gradient_sky(512, 1024)
    arrays = sf.build()
    return _frame(name, arrays, sf.make_camera(), make_camera(**HALL_CAM2),
                  device, FULL, has_env_map=sky)


def gb_pack(fr: Frame, looper=1):
    """Frame 1's G-buffer pack (B6 on the card, its twin on the CPU)."""
    cv, cv2 = fr.cams()
    return gbuffer.gbuffer_pack(cv2, cv, looper, fr.scene.bvh, **fr.gkw())



def scene_box(fr):
    """(lo, hi): the root box of the scene's BVH (3 floats each)."""
    lo = [float(v) for v in fr.arrays.bounds_lo[0]]
    hi = [float(v) for v in fr.arrays.bounds_hi[0]]
    return lo, hi


def nee_segments(fr, trv):
    """The general path's NEE segments of frame 1 (kernel_ab.py's
    `general_rays`): camera rays, their primary hits through `trv`, a
    light point per hit -> (pos [R, 3], target [R, 3], live [R])."""
    from ..models import gbuffer as general_gb
    from ..ops import lights
    from ..ops.kernels import intersect as hits
    from ..scene.mesh import LIGHT
    from ..utils import rng

    dev = fr.device
    cfg = fr.cfg.replace(tracer=TracerType.PT_FULL)
    pix, o, d = general_gb.primary_rays(fr.cam, cfg, 1, rng.SALT_CAMERA, dev)
    prim, _, _, pos, _, _, matp = hits.primary_hit(
        trv, fr.scene.prim_attr, fr.scene.mat_attr, o.contiguous(),
        d.contiguous())
    live = (prim >= 0) & (matp[:, 0].to(torch.int32) != LIGHT)
    l1, l2, l3, l4 = rng.uniform4(pix, 1, 1, rng.SALT_PT)
    ls = lights.sample_direct_light_no_visibility(fr.scene, pos, l1, l2, l3,
                                                  l4, has_env=False)
    target = pos + ls.wi * torch.clamp(ls.dist, max=1e6)[:, None]
    return pos.contiguous(), target.contiguous(), live & (ls.pdf > 0)
