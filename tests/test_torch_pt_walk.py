"""B11 and B12's MTBVH walks against the brute force of their twins, on
the CPU.

Kernels B11 (closest and any hit) and B12 (primary hit) in
`csrc/intersect.cu` cast every ray through `csrc/bvh.cuh`'s walks with
`gi_core.cuh`'s leaf test; their twins test every triangle row with
`ops.intersect_bf`. The lockstep walks of `ops/kernels/bvh_walk.py`,
given the same leaf test (`gi_plane`), walk the rays the general path's
full path tracer (`path_tracer.pt_trace`, trace_depth 5) casts at 64x32
on the headline scene `many_light_scene(64, 24)` and on `cornell_box()`:
the camera rays, every bounce's `make_offseted_ray` rays (depth 1-5,
dead lanes included: B12 sees them on the card when no mask is passed)
and every NEE segment, turned into `occlusion_ray`'s origin, direction
and limit. Bounce rays start on surfaces, unlike the camera rays B12 was
first held on. Rays with zero and non-finite directions (and segments
with non-finite or coincident ends) are added: both sides must miss.

On every lane the walk's primitive equals the brute force's and, on
hits, its distance and barycentrics bit for bit (a miss is BIG / 0 / 0
in the walk and inf / triangle 0's barycentrics in the brute force);
the any-hit walk's occlusion equals `test_occlusion_bf`'s on every lane.
"""

import math

import pytest
import torch
from _gi_rays import cast_rays

from restir_tpu_torch import convert
from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
from restir_tpu_torch.models import path_tracer
from restir_tpu_torch.ops import intersect_bf as ibf
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.ops.kernels import bvh_walk
from restir_tpu_torch.scene import procedural

W, H = 64, 32
R = W * H
DEPTH = 5
NAN, INF = math.nan, math.inf
# directions no surface can be hit along (a dead lane's zero or
# non-finite ray); the origins are inside the scenes
BAD_DIRS = [(0.0, 0.0, 0.0), (NAN, NAN, NAN), (NAN, 0.0, 1.0),
            (INF, 0.0, 0.0), (0.0, -INF, 0.0), (INF, -INF, 1.0)]


def _world(name):
    if name == "headline":
        return procedural.many_light_scene(64, 24)
    return procedural.cornell_box()


@pytest.fixture(scope="module", params=["headline", "cornell"])
def rays(request):
    """(scene, closest-hit ray sets by depth 0-5 (0: camera), NEE
    segments by depth 1-5) that pt_trace casts on the CPU."""
    arrays, camkw = _world(request.param)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.PT_FULL,
                       trace_depth=DEPTH, **mat_flags(arrays))
    _, recorded = cast_rays(path_tracer.pt_trace, scene,
                            make_camera(**camkw), cfg, 3)
    closest = [r[1:] for r in recorded if r[0] == "closest"]
    shadow = [r[1:] for r in recorded if r[0] == "shadow"]
    assert len(closest) == DEPTH + 1 and len(shadow) == DEPTH
    return scene, closest, shadow


def _closest_equal(scene, o, d):
    prim_bf, dist_bf, bary_bf = ibf.intersect_closest_bf(scene.tri_xform, o,
                                                         d)
    dist, prim, u, v, boxes, tris = bvh_walk.closest_walk(
        scene.bvh, tuple(o.T), tuple(d.T), plane=bvh_walk.gi_plane)
    assert torch.equal(prim, prim_bf)
    hit = prim >= 0
    assert torch.equal(dist[hit], dist_bf[hit])
    assert torch.equal(u[hit], bary_bf[hit, 0])
    assert torch.equal(v[hit], bary_bf[hit, 1])
    assert (boxes >= tris).all()
    return prim, tris


def _occluded_equal(scene, x, y):
    want = ibf.test_occlusion_bf(scene.tri_xform, x, y)
    o, d, limit = ibf.occlusion_ray(x, y)
    got, boxes, tris = bvh_walk.occluded_walk(
        scene.bvh, tuple(o.T), tuple(d.T), limit,
        torch.full((x.shape[0],), -1, dtype=torch.int32),
        plane=bvh_walk.gi_plane)
    assert torch.equal(got, want)
    assert (boxes >= tris).all()
    return got, tris


@pytest.mark.parametrize("depth", range(DEPTH + 1))
def test_closest_walk_equals_brute_force_on_pt_rays(rays, depth):
    """Depth 0: B12's camera rays; 1-5: its bounce rays, every lane."""
    scene, closest, _ = rays
    o, d, active = closest[depth]
    if depth == 0:
        assert active is None
    else:
        assert not bool(active.all())  # dead lanes are walked too
    prim, tris = _closest_equal(scene, o, d)
    assert bool((prim >= 0).any())
    assert float(tris.float().mean()) < scene.num_tris / 4


@pytest.mark.parametrize("depth", range(1, DEPTH + 1))
def test_occluded_walk_equals_brute_force_on_pt_nee(rays, depth):
    scene, _, shadow = rays
    x, y, active = shadow[depth - 1]
    got, _ = _occluded_equal(scene, x, y)
    assert bool(active.any()) and bool(got[active].any())


def test_degenerate_rays_miss(rays):
    """Zero and non-finite directions from camera origins miss on both
    sides; segments with a non-finite end, or of zero length, are
    not occluded."""
    scene, closest, shadow = rays
    o = closest[0][0][::64]
    n = o.shape[0]
    bad = torch.tensor(BAD_DIRS).repeat_interleave(n, 0)
    prim, _ = _closest_equal(scene, o.repeat(len(BAD_DIRS), 1), bad)
    assert (prim == -1).all()
    x = shadow[0][0][::64]
    ends = [x, x + torch.tensor([NAN, 0.0, 0.0]),
            x + torch.tensor([0.0, INF, 0.0])]
    got, tris = _occluded_equal(scene, x.repeat(3, 1), torch.cat(ends))
    assert not bool(got.any()) and not bool(tris.any())
