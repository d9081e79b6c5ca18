"""B8's MTBVH walks against the brute force of its twin, on the CPU.

Kernel B8 (`csrc/gi_trace.cu`) casts every bounce ray and every NEE
shadow segment through `csrc/bvh.cuh`'s walks with `gi_core.cuh`'s leaf
test; its twin `gi.gi_trace_ref` tests every triangle row with
`ops.intersect_bf`. The lockstep walks of `ops/kernels/bvh_walk.py`,
given the GI leaf test (`gi_plane`, the arithmetic of `intersect_bf`),
walk the rays the twin actually casts at depth 5 (`_gi_rays`): the
closest-hit rays of every bounce (depth 1-5) and the NEE shadow segments
(depth 2-5), at 64x32 from B1's primary hits on `cornell_box()` with
tests/test_torch_gi.py's `lambert` and `metal_glass` blocks and on the
headline scene `many_light_scene(64, 24)`. These rays start on surfaces,
graze, and leave glass from inside, which the primary and shadow rays of
tests/test_torch_bvh.py never do.

On every lane the twin traces, the walk's primitive equals the brute
force's and, on hits, its distance and barycentrics bit for bit (a miss
is BIG / 0 / 0 in the walk and inf / triangle 0's barycentrics in the
brute force); the any-hit walk's occlusion equals the brute force's on
every lane.
"""

import pytest
import torch
from _gi_rays import gi_twin_rays

from restir_tpu_torch import convert
from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
from restir_tpu_torch.models import restir_di_fused, restir_gi
from restir_tpu_torch.ops import intersect_bf as ibf
from restir_tpu_torch.ops.camera import make_camera, pack_camera
from restir_tpu_torch.ops.kernels import bvh_walk, fused_di
from restir_tpu_torch.scene import procedural

W, H = 64, 32
R = W * H
DEPTH = 5


def _world(name):
    if name == "headline":
        return procedural.many_light_scene(64, 24)
    blocks = {"lambert": ("lambert", "lambert"),
              "metal_glass": ("metal", "glass")}[name]
    return procedural.cornell_box(block_materials=blocks)


@pytest.fixture(scope="module", params=["lambert", "metal_glass", "headline"])
def rays(request):
    """(scene, closest-hit ray sets by depth, shadow ray sets by depth)
    that B8's twin casts from B1's primary hits."""
    arrays, camkw = _world(request.param)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                       trace_depth=DEPTH, **mat_flags(arrays))
    cv = pack_camera(make_camera(**camkw))
    gb, _ = fused_di.di_resident_ref(
        cv, cv, 1, torch.zeros((fused_di.PT_CH, R)), scene.tables, width=W,
        height=H, has_met=cfg.scene_has_metallic)
    in_pack, _ = restir_di_fused.gi_packs(scene, gb)
    _, recorded = gi_twin_rays(in_pack, 3, scene,
                               **restir_gi.trace_kwargs(scene, cfg))
    closest = [r[1:] for r in recorded if r[0] == "closest"]
    shadow = [r[1:] for r in recorded if r[0] == "shadow"]
    assert len(closest) == DEPTH and len(shadow) == DEPTH - 1
    return scene, closest, shadow


@pytest.mark.parametrize("depth", range(1, DEPTH + 1))
def test_closest_walk_equals_brute_force_on_b8_bounces(rays, depth):
    scene, closest, _ = rays
    o, d, active = closest[depth - 1]
    prim_bf, dist_bf, bary_bf = ibf.intersect_closest_bf(scene.tri_xform, o,
                                                         d, active)
    lanes = torch.nonzero(active)[:, 0]
    assert lanes.numel() > 0  # some paths live at this depth
    dist, prim, u, v, boxes, tris = bvh_walk.closest_walk(
        scene.bvh, tuple(o[lanes].T), tuple(d[lanes].T),
        plane=bvh_walk.gi_plane)
    assert torch.equal(prim, prim_bf[lanes])
    hit = prim >= 0
    assert torch.equal(dist[hit], dist_bf[lanes][hit])
    assert torch.equal(u[hit], bary_bf[lanes][hit, 0])
    assert torch.equal(v[hit], bary_bf[lanes][hit, 1])
    assert (boxes >= tris).all()


@pytest.mark.parametrize("depth", range(2, DEPTH + 1))
def test_occluded_walk_equals_brute_force_on_b8_shadow_rays(rays, depth):
    scene, _, shadow = rays
    x, y, active = shadow[depth - 2]
    want = ibf.test_occlusion_bf(scene.tri_xform, x, y, active)
    o, d, limit = ibf.occlusion_ray(x, y)
    limit = torch.where(active, limit, -1.0)  # B8 casts active lanes only
    got, boxes, tris = bvh_walk.occluded_walk(
        scene.bvh, tuple(o.T), tuple(d.T), limit,
        torch.full((R,), -1, dtype=torch.int32), plane=bvh_walk.gi_plane)
    assert bool(active.any())
    assert torch.equal(got, want)
    assert (boxes[~active] == 0).all()  # lanes B8 does not cast walk nothing
