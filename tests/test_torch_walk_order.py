"""B13's and B14's launch order and geometry on the CPU (no card needed).

B13's primary and any hit and B14 launch a batch that holds one ray per
pixel of a band (geometry `(width, pix0)`) on 8x4-pixel warps. Here: the host
mirror of that order (`gbuffer.tile_order` with the band arguments,
less pix0: csrc/intersect.cu's `ray_of<TILES>`) covers every ray of the
band exactly once, the wrappers refuse a geometry that cannot hold the
batch before any device work, every general-path call site passes its
band's geometry, and on the CPU, where the plain versions ignore it,
the geometry changes no result.
"""

import pytest
import torch

from restir_tpu_torch import convert, models, parallel, renderer
from restir_tpu_torch.config import RenderConfig, TracerType
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops.camera import make_camera, pixel_centers, sample_rays
from restir_tpu_torch.ops.kernels import gbuffer
from restir_tpu_torch.ops.kernels import intersect as ki
from restir_tpu_torch.ops.primary import trace_primary
from restir_tpu_torch.scene.procedural import many_light_scene

# (width, height, pix0, r): whole frames, widths that are not multiples
# of 8 or 32, bands of whole rows from mid-frame, bands that start and
# end mid-row, batches below one warp and one tile row
GRID = [
    (32, 8, 0, 256), (256, 64, 0, 16384), (100, 37, 0, 3700),
    (13, 5, 0, 65), (1920, 1080, 360 * 1920, 360 * 1920),
    (100, 37, 12 * 100, 9 * 100), (100, 37, 137, 1000), (7, 50, 3, 20),
    (64, 16, 64 * 15 + 60, 4), (1, 40, 0, 40), (33, 9, 32, 1),
]


@pytest.mark.parametrize("width,height,pix0,r", GRID)
def test_launch_orders_cover_the_band_once(width, height, pix0, r):
    """The threads of B13's tiled launch (tile_order, less pix0) hold every
    ray of the band exactly once, and each warp's rays lie in one 8x4
    pixel patch."""
    g = gbuffer.tile_order(width, height, pix0=pix0, r=r)
    p = g[g >= 0] - pix0
    assert torch.equal(p.sort().values, torch.arange(r))
    rows = (pix0 + r - 1) // width - pix0 // width + 1
    assert g.numel() == -(-width // 32) * -(-rows // 8) * 256
    warps = g.view(-1, 32)
    live = warps >= 0
    for coord, span in ((warps % width, 8), (warps // width, 4)):
        hi = torch.where(live, coord, -1).amax(1)
        lo = torch.where(live, coord, 2**40).amin(1)
        assert bool(((hi - lo)[live.any(1)] < span).all())


@pytest.mark.parametrize("geom,r", [
    ((0, 0), 10), ((-4, 0), 10), ((16, -1), 10),
    ((1, 0), 65535 * 8 + 1),  # more tile rows than a launch holds
    ((4096, 2**31 - 8192), 4096),  # pixel indices past int32
    ((2**30, 0), 4),  # the tile rows' pixel indices past int32
])
def test_geometry_that_cannot_hold_the_batch_raises(geom, r):
    o = torch.zeros((r, 3))
    with pytest.raises(ValueError, match="geometry"):
        ki.check_geometry(geom, r)
    # the wrappers refuse before any device work (no launch is counted)
    trv = tix.TraversalArrays(tri_xform=None, planes=None, rows=None,
                              size=0, method="bvh", walk=None)
    before = (ki.mt_primary_launches, ki.mt_any_launches,
              ki.heatmap_launches)
    with pytest.raises(ValueError, match="geometry"):
        ki.primary_hit(trv, None, None, o, o, geom=geom)
    with pytest.raises(ValueError, match="geometry"):
        ki.any_hit(trv, o, o, geom=geom)
    with pytest.raises(ValueError, match="geometry"):
        ki.heatmap(trv, o, o, geom=geom)
    assert (ki.mt_primary_launches, ki.mt_any_launches,
            ki.heatmap_launches) == before


@pytest.mark.parametrize("geom,r", [((1, 0), 65535 * 8), ((1920, 0), 1),
                                    ((1920, 1919), 2), ((7, 10**6), 10)])
def test_geometry_that_holds_the_batch_passes(geom, r):
    assert ki.check_geometry(geom, r) == geom


@pytest.fixture(scope="module")
def walk_scene():
    arrays, camkw = many_light_scene(4, 2)
    scene = convert.scene_from_numpy(arrays, "cpu")
    return scene, make_camera(**camkw), tix.traversal_arrays(scene, "bvh")


def test_geometry_leaves_cpu_results_unchanged(walk_scene):
    """On the CPU the plain versions ignore the geometry: trace_primary and
    test_occlusion return the same tensors with and without it, for a
    band from mid-frame."""
    scene, cam, trv = walk_scene
    w, h, pix0, r = 24, 16, 24 * 5, 24 * 6
    x, y = pixel_centers(w, h, "cpu", pix0, r)
    half = torch.full_like(x, 0.5)
    o, d = sample_rays(cam, w, h, x, y, half, half)
    active = torch.arange(r) % 3 != 0
    plain = trace_primary(scene, trv, o, d, False, active)
    banded = trace_primary(scene, trv, o, d, False, active, geom=(w, pix0))
    for a, b in zip(plain, banded):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    hit = plain[2].prim_id >= 0
    assert bool(hit.any())
    target = torch.tensor([0.0, 8.0, 0.0]).expand_as(o)
    pos = plain[0].pos
    assert torch.equal(tix.test_occlusion(trv, pos, target, hit),
                       tix.test_occlusion(trv, pos, target, hit, (w, pix0)))


W, H = 16, 8


@pytest.mark.parametrize("tracer", [
    TracerType.PT_DIRECT, TracerType.PT_FULL, TracerType.RESTIR_DI,
    TracerType.RESTIR_GI, TracerType.GBUFFER_PREVIEW,
    TracerType.BVH_VISUALIZE])
@pytest.mark.parametrize("bands", [1, 2])
def test_call_sites_pass_their_band(walk_scene, monkeypatch, tracer, bands):
    """Every ray batch of the general path that reaches B13's primary or
    any hit (`trace_primary`, `ix.test_occlusion`) or B14 (`bvh_heatmap`'s
    `heatmap`) carries its band's geometry: (frame width, the band's
    first global pixel), one ray per pixel of the band."""
    scene, cam, _ = walk_scene
    seen, heat = [], []
    real_a, real_h = ki.any_hit, ki.heatmap

    def spy(*args, geom=None, **kw):
        seen.append((args[2].shape[0], geom))
        return trace_primary(*args, geom=geom, **kw)

    def any_hit(trv, x, y, active=None, geom=None):
        seen.append((x.shape[0], geom))
        return real_a(trv, x, y, active, geom)

    def heatmap(trv, o, d, geom=None):
        heat.append((o.shape[0], geom))
        return real_h(trv, o, d, geom)

    for module in (models.gbuffer, models.path_tracer, models.restir_gi):
        monkeypatch.setattr(module, "trace_primary", spy)
    monkeypatch.setattr(ki, "any_hit", any_hit)
    monkeypatch.setattr(ki, "heatmap", heatmap)
    cfg = RenderConfig(width=W, height=H, tracer=tracer, intersector="bvh",
                       trace_depth=2)
    state = renderer.init_state(cfg, cam, device="cpu")
    if bands == 1:
        renderer.step(scene, state, cam, cfg)
    else:
        mesh = parallel.make_mesh(["cpu"] * bands)
        step = parallel.make_sharded_step(cfg, mesh, state)
        step(parallel.shard_scene(scene, mesh),
             parallel.shard_state(state, mesh, cfg), cam)
    r = W * H // bands
    assert seen
    assert set(seen) <= {(r, (W, b * r)) for b in range(bands)}
    assert {g for _, g in seen} == {(W, b * r) for b in range(bands)}
    if tracer == TracerType.BVH_VISUALIZE:
        assert sorted(heat) == [(r, (W, b * r)) for b in range(bands)]
    else:
        assert not heat
