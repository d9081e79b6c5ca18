"""Kernel-vs-twin checks of B1 (with its env and texture branches), B2,
B3, B4 (also on images that cut their tiles ragged), B5, the SVGF
variance kernels (on whole frames, band images and ragged tiles), B6,
B7, the general path's B10,
B11, B12, B13 and B14 (bit for bit), the general EAW / SVGF step, and
ReSTIR GI's B8 and B9 on a CUDA card; B13's build and launch errors,
its primary and any hit on 8x4-pixel warps on bands, ragged widths and
edge-case rays; its closest hit in sorted ray order (the ray key, the
radix sort, the walk through the permutation) at several batch sizes,
on edge-case rays and on a batch of dead lanes;
the MTBVH walk counts of B6, B7, B8, B11 and B12 against the lockstep
twin, B1a against B6 + B7, and the full path tracer's frames with and
without B12's mask of live lanes; B7's light search alone against its
twin and its mirror, and against B1 bit for bit where its targets leave
the division's fast path; B7 and B10 against their twins on 2,450 light
rows, and through renderer.step there.

These need nvcc and a GPU; without a card they skip (the decision is
made inside the `cuda_device` fixture, never at import). On a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The gates are restir_tpu_torch.parity's; the shapes are small so the
file runs in seconds (chip_smoke.py checks the 1080p shapes).
"""

import numpy as np
import pytest
import torch

from restir_tpu_torch import convert, parity
from restir_tpu_torch.ops.camera import make_camera, pack_camera
from restir_tpu_torch import renderer
from restir_tpu_torch.config import RenderConfig, TracerType
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops import intersect_bf
from restir_tpu_torch.ops.camera import pixel_centers, sample_rays
from restir_tpu_torch.ops.kernels import (
    atrous,
    bvh_walk,
    fused_di,
    gbuffer,
    gi,
    reuse,
    ris_cdf,
    spatial,
    svgf,
)
from restir_tpu_torch.ops.kernels import intersect as ki
from restir_tpu_torch.ops.kernels import ray_order as ro
from restir_tpu_torch.utils import rng
from restir_tpu_torch.scene.procedural import (
    cornell_box,
    env_scene,
    many_light_scene,
    textured_scene,
)

W, H = 256, 64
R = W * H

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frame(cuda_device):
    arrays, camkw = many_light_scene(16, 6)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    cv0, cv1 = pack_camera(cam0, cuda_device), pack_camera(cam1, cuda_device)
    zeros = torch.zeros((fused_di.PT_CH, R), device=cuda_device)
    _, pt0 = fused_di.di_resident_cuda(cv0, cv0, 0, zeros, scene.tables,
                                       scene.bvh, width=W, height=H)
    return scene, cv0, cv1, pt0


@pytest.mark.parametrize("temporal", [True, False])
def test_b1_kernel_matches_twin(frame, temporal):
    scene, cv0, cv1, pt0 = frame
    kw = dict(width=W, height=H, temporal=temporal)
    gb_k, pt_k = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                           scene.bvh, **kw)
    gb_r, pt_r = fused_di.di_resident_ref(cv1, cv0, 1, pt0, scene.tables,
                                          **kw)
    fails, stats = parity.gb_pt_report(gb_r, pt_r, gb_k, pt_k)
    assert not fails, (fails, stats)


def test_b2_kernel_matches_twin(frame):
    scene, cv0, cv1, pt0 = frame
    gb, pt = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                       scene.bvh, width=W, height=H)
    offs = spatial.spatial_offsets(1, R, W, 5, 5.0, gb.device)
    acc = torch.as_tensor(np.random.default_rng(0).random(
        (3, R), dtype=np.float32), device=gb.device)
    before = spatial.launches
    k = spatial.spatial_shade_cuda(offs, gb, pt, acc.clone(), 1, 3,
                                   width=W, height=H)
    assert spatial.launches == before + 1
    r = spatial.spatial_shade_ref(offs, gb, pt, acc.clone(), 1, 3,
                                  width=W, height=H)
    assert parity.close_fraction(r, k, 1e-5, 1e-6) >= 0.999


@pytest.mark.parametrize("level", [0, 2, 4])
def test_b3_kernel_matches_twin(frame, level):
    scene, cv0, cv1, pt0 = frame
    gb, _ = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                      scene.bvh, width=W, height=H)
    color = torch.as_tensor(np.random.default_rng(1).random(
        (3, R), dtype=np.float32), device=gb.device)
    kw = dict(level=level, width=W, height=H, sig_l=1.0, sig_n=0.2,
              sig_d=64.0)
    k = atrous.atrous_level_cuda(color, gb, **kw)
    r = atrous.atrous_level_ref(color, gb, **kw)
    assert parity.close_fraction(r, k, 1e-5, 1e-6) >= 0.999


def _guides(w, h, dev):
    """A seeded colour [3, R] and gb pack whose guides (prim remap -1..3
    in blocks, normals and positions per block with noise) reject taps
    at the block edges, for a w x h image."""
    g = np.random.default_rng(w * h)
    r = w * h
    y, x = np.divmod(np.arange(r), w)
    prim = (x // 24 + 3 * (y // 10)) % 5 - 1
    gb = np.zeros((fused_di.GB_CH, r), np.float32)
    gb[fused_di.G_PRIMR] = prim
    n = g.normal(size=(5, 3))[prim + 1].T + 0.05 * g.normal(size=(3, r))
    gb[fused_di.G_NORM:fused_di.G_NORM + 3] = n / np.linalg.norm(n, axis=0)
    gb[fused_di.G_POS:fused_di.G_POS + 3] = (
        np.stack([x * 0.01, y * 0.01, 0.1 * prim])
        + 0.01 * g.normal(size=(3, r)))
    color = g.random((3, r), dtype=np.float32)
    return (torch.as_tensor(color, device=dev),
            torch.as_tensor(gb, device=dev))


# ragged tiles: 200x75 and 1920x1080 cut the 32 x 8 tiles, and 24 rows
# are fewer than the level-4 stride's reach (2 x 16)
RAGGED = [(200, 75), (1920, 1080), (256, 24)]


@pytest.mark.parametrize("width,height", RAGGED)
def test_b3_matches_twin_on_ragged_tiles(cuda_device, width, height):
    color, gb = _guides(width, height, cuda_device)
    kw = dict(width=width, height=height, sig_l=1.0, sig_n=0.2, sig_d=64.0)
    for level in range(5):
        before = atrous.launches
        k = atrous.atrous_level_cuda(color, gb, level=level, **kw)
        assert atrous.launches == before + 1
        r = atrous.atrous_level_ref(color, gb, level=level, **kw)
        assert parity.close_fraction(r, k, 1e-5, 1e-6) >= 0.999, level
        color = k


@pytest.mark.parametrize("width,height", RAGGED)
def test_b4_matches_twin_on_ragged_tiles(cuda_device, width, height):
    color, gb = _guides(width, height, cuda_device)
    g = np.random.default_rng(7)
    var = torch.as_tensor(g.random(width * height, dtype=np.float32),
                          device=cuda_device)
    kw = dict(width=width, height=height, sig_l=1.0, sig_n=128.0, sig_d=4.0)
    for level in range(5):
        fv = svgf.filter_variance(var, width=width, height=height)
        before = atrous.svgf_launches
        ck, vk = atrous.atrous_svgf_cuda(color, var, fv, gb, level=level,
                                         **kw)
        assert atrous.svgf_launches == before + 1
        cr, vr = atrous.atrous_svgf_ref(color, var, fv, gb, level=level,
                                        **kw)
        assert parity.close_fraction(cr, ck, 1e-5, 1e-6) >= 0.999, level
        assert parity.close_fraction(vr[None], vk[None], 1e-5,
                                     1e-6) >= 0.999, level
        color, var = ck, vk


def test_b3_b4_match_twins_with_sigmas_outside_the_hoisted_range(
        cuda_device):
    """A sigma outside [FAST_MIN, FAST_MAX] sends B3 and B4 to div.rn
    itself; both still match their twins."""
    color, gb = _guides(200, 75, cuda_device)
    var = torch.as_tensor(np.random.default_rng(8).random(
        200 * 75, dtype=np.float32), device=cuda_device)
    fv = svgf.filter_variance(var, width=200, height=75)
    for level in (0, 3):
        kw = dict(level=level, width=200, height=75, sig_l=1.0, sig_n=2e6,
                  sig_d=64.0)
        k = atrous.atrous_level_cuda(color, gb, **kw)
        r = atrous.atrous_level_ref(color, gb, **kw)
        assert parity.close_fraction(r, k, 1e-5, 1e-6) >= 0.999, level
        kw.update(sig_n=128.0, sig_d=2e6)
        ck, vk = atrous.atrous_svgf_cuda(color, var, fv, gb, **kw)
        cr, vr = atrous.atrous_svgf_ref(color, var, fv, gb, **kw)
        assert parity.close_fraction(cr, ck, 1e-5, 1e-6) >= 0.999, level
        assert parity.close_fraction(vr[None], vk[None], 1e-5,
                                     1e-6) >= 0.999, level


@pytest.mark.parametrize("sig", [1e-6, 0.2, 0.37, 1.0, 4.0, 64.0, 128.0,
                                 3.3e5, 1e6])
def test_atrous_hoisted_division_matches_div_rn(cuda_device, sig):
    """B3 / B4 divide by a sigma through div.rn's fast path with the
    reciprocal hoisted; after expf it must agree with div.rn for every
    float d >= 0 (the config's sigmas and the ends of the range)."""
    assert atrous.FAST_MIN <= sig <= atrous.FAST_MAX
    assert atrous.division_mismatches(sig, cuda_device) == 0


@pytest.fixture(scope="module")
def large(cuda_device):
    """many_light_scene(16, 120): 1482 triangles, over the resident limit."""
    arrays, camkw = many_light_scene(16, 120)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    cv0, cv1 = pack_camera(cam0, cuda_device), pack_camera(cam1, cuda_device)
    prev = torch.as_tensor(np.abs(np.random.default_rng(11).normal(
        size=(fused_di.PT_CH, R))).astype(np.float32), device=cuda_device)
    return scene, cv0, cv1, prev


def test_b6_kernel_matches_twin(large):
    scene, cv0, cv1, _ = large
    kw = dict(width=W, height=H)
    before = gbuffer.launches
    gb_k = gbuffer.gbuffer_cuda(cv1, cv0, 3, scene.bvh, **kw)
    assert gbuffer.launches == before + 1
    gb_r = gbuffer.gbuffer_ref(cv1, cv0, 3, scene.bvh, **kw)
    fails, stats = parity.gb_report(gb_r, gb_k)
    assert not fails, (fails, stats)


@pytest.mark.parametrize("temporal", [True, False])
def test_b7_kernel_matches_twin(large, temporal):
    scene, cv0, cv1, prev = large
    gb = gbuffer.gbuffer_cuda(cv1, cv0, 3, scene.bvh, width=W, height=H)
    kw = dict(temporal=temporal)
    before = (reuse.launches, fused_di.temporal_launches)
    pt_k = reuse.reuse_cuda(gb, prev, 3, scene.tables, scene.bvh, width=W,
                            **kw)
    assert (reuse.launches, fused_di.temporal_launches) == (
        before[0] + 1, before[1] + 1)
    pt_r = reuse.reuse_ref(gb, prev, 3, scene.tables, **kw)
    fails, stats = parity.pt_report(pt_r, pt_k)
    assert not fails, (fails, stats)


def test_walk_counts_match_lockstep_twin(large):
    """The kernels' per-ray box / triangle test counts equal the lockstep
    walk's (a wrong table choice still finds the hit, but not with the
    same work)."""
    scene, cv0, cv1, _ = large
    gb, st = gbuffer.gbuffer_cuda(cv1, cv0, 3, scene.bvh, width=W, height=H,
                                  stats=True)
    o = tuple(cv1[i].expand(R) for i in range(3))
    d = tuple(gb[fused_di.G_DIR + i] for i in range(3))
    _, prim, _, _, boxes, tris = bvh_walk.closest_walk(scene.bvh, o, d)
    assert (boxes == st[0]).float().mean() >= 0.99
    assert (tris == st[1]).float().mean() >= 0.99
    assert (prim.float() == gb[fused_di.G_PRIM]).float().mean() >= 0.998

    rs, st = reuse.candidates_cuda(gb, 3, scene.tables, scene.bvh, width=W,
                                   stats=True)
    wi = tuple(rs[fused_di.RS_WI + i] for i in range(3))
    o = tuple(gb[fused_di.G_POS + i] + wi[i] * 1e-5 for i in range(3))
    limit = rs[fused_di.RS_DIST] * (1.0 - 1e-3) - 1e-4
    _, boxes, tris = bvh_walk.occluded_walk(scene.bvh, o, wi, limit,
                                            gb[fused_di.G_PRIM])
    assert (boxes == st[0]).float().mean() >= 0.99
    assert (tris == st[1]).float().mean() >= 0.99


@pytest.fixture(scope="module")
def ragged(cuda_device):
    """The large scene at 200x76: the frame cuts B6 / B7's 32x8 pixel
    blocks ragged on both axes."""
    arrays, camkw = many_light_scene(16, 120)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    cv0, cv1 = pack_camera(cam0, cuda_device), pack_camera(cam1, cuda_device)
    return scene, cv0, cv1, 200, 76


def test_b6_b7_match_twins_on_ragged_frame(ragged):
    """B6 and B7 on 2-D pixel tiles against their twins on a frame whose
    edges cut the tiles (R is not whole 1024-pixel tiles, so B7's
    candidates are held against the twin's RIS and shadow stages without
    B1b's merge)."""
    scene, cv0, cv1, w, h = ragged
    gb_k = gbuffer.gbuffer_cuda(cv1, cv0, 3, scene.bvh, width=w, height=h)
    gb_r = gbuffer.gbuffer_ref(cv1, cv0, 3, scene.bvh, width=w, height=h)
    fails, stats = parity.gb_report(gb_r, gb_k)
    assert not fails, (fails, stats)
    rs_tiles = reuse.candidates_cuda(gb_k, 3, scene.tables, scene.bvh,
                                     width=w)
    li, wi, dist, wt = fused_di.ris_pixels(
        gb_k, torch.arange(w * h, device=gb_k.device), 3, scene.tables, k=4,
        single_sided=True, has_met=True)
    wt = fused_di.shadow_pixels(gb_k, wi, dist, wt, scene.tables.planes)
    rs_r = torch.cat([li, wi, dist[None], wt[None]])

    def as_pt(rs):  # the rs channels sit where pt_report reads pt's
        pt = torch.zeros((fused_di.PT_CH, rs.shape[1]), device=rs.device)
        pt[:fused_di.RS_CH] = rs
        return pt

    fails, stats = parity.pt_report(as_pt(rs_r), as_pt(rs_tiles))
    assert not fails, (fails, stats)


def _b7_frames(ragged, env_tex):
    """(scene, B6's gb pack, width, has_env): the ragged frame (128 light
    rows) and the env_tex fixture's frame (640 rows with the env tiles)."""
    scene, cv0, cv1, w, h = ragged
    yield scene, gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=w,
                                      height=h), w, False
    scene, cv0, cv1, _, flags = env_tex
    yield scene, gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W,
                                      height=H, **flags), W, \
        flags.get("has_env", False)


def test_b7_targets_per_pixel_within_search_bound(ragged, env_tex):
    """The COUNT build's third row: each pixel evaluates between n_l and
    n_l + k * S light targets (n_l the rows that hold lights, S the
    checkpoint spacing), on the 128-row and the 640-row (env) tables; its
    packs equal the plain build's."""
    k = 4
    for scene, gb, w, has_env in _b7_frames(ragged, env_tex):
        rs, st = reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                       width=w, k=k, has_env=has_env,
                                       stats=True)
        n_l = scene.tables.n_lights + (reuse.N_ENV if has_env else 0)
        assert st.shape == (3, gb.shape[1])
        assert int(st[2].min()) >= n_l
        seg = reuse.seg_for(scene.tables.n_lights, has_env)
        assert int(st[2].max()) <= n_l + k * seg
        assert torch.equal(rs, reuse.candidates_cuda(
            gb, 1, scene.tables, scene.bvh, width=w, k=k, has_env=has_env))


def _sampled_dir(gb, tables, has_env, idx, pix, looper):
    """The direction candidate 0 samples on light rows idx [b] (a point on
    the area light, or in the env tile), as B7's ris_finish draws it."""
    lights, _ = tables.light_rows(has_env)
    _, r2, r3, _ = rng.uniform4(pix, looper, fused_di.CTR_RIS,
                                rng.SALT_RESTIR)
    row = lights[idx].T
    sr = torch.sqrt(torch.clamp(r3, min=0.0))
    d = torch.stack([row[c] + (1.0 - sr) * row[c + 3] + r2 * sr * row[c + 6]
                     - gb[fused_di.G_POS + c] for c in range(3)])
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=0), min=1e-20)
    if has_env:
        phi = (row[0] + r2 * row[3]) * (2.0 * np.pi)
        th = (row[1] + r3 * row[6]) * np.pi
        env = torch.stack([torch.cos(phi) * torch.sin(th), torch.cos(th),
                           torch.sin(phi) * torch.sin(th)])
        d = torch.where(idx >= tables.n_lights, env, d)
    return d


@pytest.mark.parametrize("k", [1, 4])
def test_b7_search_equals_cpu_mirror(ragged, env_tex, k):
    """B7 runs the search its mirror (`reuse.ris_search`) runs: the COUNT
    build's third row equals the mirror's targets evaluated, pixel for
    pixel, at the kernel's spacing; at k = 1 every winner's direction is
    the one sampled on the mirror's pick."""
    for scene, gb, w, has_env in _b7_frames(ragged, env_tex):
        rs, st = reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                       width=w, k=k, has_env=has_env,
                                       stats=True)
        pix = torch.arange(gb.shape[1], device=gb.device)
        seg = reuse.seg_cuda(scene.tables.n_lights, has_env)
        idx, _, _, evaluated = reuse.ris_search(
            gb, pix, 1, scene.tables, k=k, single_sided=True,
            has_env=has_env, seg=seg)
        assert torch.equal(st[2].long(), evaluated)
        if k == 1:
            wi = rs[fused_di.RS_WI:fused_di.RS_WI + 3]
            won = (wi != 0.0).any(dim=0)
            assert float(won.float().mean()) > 0.3
            ref = _sampled_dir(gb, scene.tables, has_env, idx[0], pix, 1)
            assert float((wi - ref)[:, won].abs().max()) < 1e-4


@pytest.mark.parametrize("n_area,has_env", [(128, False), (128, True),
                                            (4, True), (2000, False),
                                            (2000, True), (2450, False),
                                            (2200, True), (10000, False)])
def test_b7_seg_matches_host_mirror(cuda_device, n_area, has_env):
    """The spacing B7 takes on the card (b7_seg) equals `reuse.seg_for`,
    the host mirror the CPU search and the tests use, also past the
    tables a block could stage whole."""
    assert reuse.seg_cuda(n_area, has_env) == reuse.seg_for(n_area, has_env)


def test_mtbvh_path_matches_b1_on_resident_scene(frame):
    """B6 + B7 + B1b on a scene B1 renders resident agree with B1."""
    scene, cv0, cv1, pt0 = frame
    gb_b1, pt_b1 = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                             scene.bvh, width=W, height=H)
    gb = gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W, height=H)
    pt = reuse.reuse_cuda(gb, pt0, 1, scene.tables, scene.bvh, width=W)
    fails, stats = parity.gb_pt_report(gb_b1, pt_b1, gb, pt)
    assert not fails, (fails, stats)


# ---- env map, textures and SVGF (B1 / B6 / B7 branches, B4, B5) ----


@pytest.fixture(scope="module", params=["env", "textures"])
def env_tex(cuda_device, request):
    """env_scene (has_env) or textured_scene(aux_maps=True) (with_textures)
    on the card, with a frame-0 history from B1."""
    if request.param == "env":
        arrays, camkw = env_scene()
        flags = dict(has_env=True)
    else:
        arrays, camkw = textured_scene(aux_maps=True)
        flags = dict(with_textures=True)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.2, camkw["position"][1],
                                                camkw["position"][2])})
    cv0, cv1 = pack_camera(cam0, cuda_device), pack_camera(cam1, cuda_device)
    zeros = torch.zeros((fused_di.PT_CH, R), device=cuda_device)
    _, pt0 = fused_di.di_resident_cuda(cv0, cv0, 0, zeros, scene.tables,
                                       scene.bvh, width=W, height=H, **flags)
    return scene, cv0, cv1, pt0, flags


def test_b1_env_tex_kernel_matches_twin(env_tex):
    scene, cv0, cv1, pt0, flags = env_tex
    kw = dict(width=W, height=H, **flags)
    gb_k, pt_k = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                           scene.bvh, **kw)
    gb_r, pt_r = fused_di.di_resident_ref(cv1, cv0, 1, pt0, scene.tables,
                                          **kw)
    fails, stats = parity.gb_pt_report(gb_r, pt_r, gb_k, pt_k)
    assert not fails, (fails, stats)
    hit = (gb_r[fused_di.G_PRIM] == gb_k[fused_di.G_PRIM])
    alb = slice(fused_di.G_ALB, fused_di.G_ALB + 3)
    assert parity.close_fraction(gb_r[alb][:, hit], gb_k[alb][:, hit],
                                 1e-4, 1e-5) >= 0.99


def test_b6_b7_env_tex_match_b1(env_tex):
    """B6 + B7 + B1b on the env / textured scenes equal B1 exactly."""
    scene, cv0, cv1, pt0, flags = env_tex
    gb_b1, pt_b1 = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                             scene.bvh, width=W, height=H,
                                             **flags)
    gb = gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W, height=H,
                              **flags)
    pt = reuse.reuse_cuda(gb, pt0, 1, scene.tables, scene.bvh, width=W,
                          has_env=flags.get("has_env", False))
    assert torch.equal(gb, gb_b1) and torch.equal(pt, pt_b1)


@pytest.fixture(scope="module")
def svgf_inputs(frame):
    """A real gb pack from B1 and a random previous svgf pack whose prim /
    normal history is the gb's own, so most pixels blend."""
    scene, cv0, cv1, pt0 = frame
    gb, _ = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                      scene.bvh, width=W, height=H)
    g = np.random.default_rng(5)
    prev = torch.as_tensor(g.random((svgf.SV_CH, R), dtype=np.float32),
                           device=gb.device)
    prev[svgf.SV_HIST] = torch.as_tensor(
        g.integers(0, 8, R).astype(np.float32), device=gb.device)
    prev[svgf.SV_PRIM] = gb[fused_di.G_PRIMR]
    prev[svgf.SV_NORM:svgf.SV_NORM + 3] = gb[fused_di.G_NORM:
                                             fused_di.G_NORM + 3]
    color = torch.as_tensor(g.random((3, R), dtype=np.float32),
                            device=gb.device)
    return gb, color, prev


def test_b5_kernel_matches_twin(svgf_inputs):
    gb, color, prev = svgf_inputs
    before = svgf.temporal_launches
    k = svgf.svgf_temporal_cuda(gb, color, prev)
    assert svgf.temporal_launches == before + 1
    r = svgf.svgf_temporal_ref(gb, color, prev)
    assert parity.close_fraction(r, k, 1e-6, 0.0) >= 0.9999
    assert float(k[svgf.SV_HIST].max()) > 0.0  # history really blended


def test_variance_kernels_match_twins(svgf_inputs):
    """The variance kernel (estimate + level-0 prefilter, one launch) and
    the prefilter kernel against their twins on the whole frame, on a
    band image (rows of the pack with their halo rows, read in place)
    and on the [R, 3] history's transpose, which must give the pack
    rows' bits."""
    gb, color, prev = svgf_inputs
    sv = svgf.svgf_temporal_cuda(gb, color, prev)
    m = sv[svgf.SV_M1:svgf.SV_M1 + 3]
    before = svgf.variance_launches
    var_k, fv0_k = svgf.estimate_variance(m, width=W, height=H)
    assert svgf.variance_launches == before + 1
    var_r, fv0_r = svgf.estimate_variance(m.cpu(), width=W, height=H)
    assert parity.close_fraction(var_r, var_k, 1e-6, 1e-7) >= 0.9999
    assert parity.close_fraction(fv0_r, fv0_k, 1e-6, 1e-7) >= 0.9999
    fv_k = svgf.filter_variance(var_k, width=W, height=H)
    assert svgf.variance_launches == before + 2
    fv_r = svgf.filter_variance(var_k.cpu(), width=W, height=H)
    assert parity.close_fraction(fv_r, fv_k, 1e-6, 1e-7) >= 0.9999
    assert torch.equal(fv_k, fv0_k)  # one prefilter, either kernel
    history = m.T.contiguous()  # [R, 3], as the general path keeps it
    var_t, fv_t = svgf.estimate_variance(history.T, width=W, height=H)
    assert torch.equal(var_t, var_k) and torch.equal(fv_t, fv0_k)
    # a band image: rows 13 .. 13 + 27 of the frame, a view of the pack
    y0, h = 13, 27
    band = m[:, y0 * W:(y0 + h) * W]
    var_b, fv_b = svgf.estimate_variance(band, width=W, height=h)
    want_v, want_f = svgf.estimate_variance(band.cpu(), width=W, height=h)
    assert parity.close_fraction(want_v, var_b, 1e-6, 1e-7) >= 0.9999
    assert parity.close_fraction(want_f, fv_b, 1e-6, 1e-7) >= 0.9999
    # inner rows see the same neighbours as in the whole frame
    inner = slice((y0 + 1) * W, (y0 + h - 1) * W)
    assert torch.equal(var_b[W:(h - 1) * W], var_k[inner])


@pytest.mark.parametrize("width,height", RAGGED + [(45, 13), (33, 1)])
def test_variance_kernels_match_twins_on_ragged_tiles(cuda_device, width,
                                                      height):
    """Widths and heights that cut the 32x8 tiles: masked, not padded."""
    g = np.random.default_rng(9)
    r = width * height
    m1 = g.random(r, dtype=np.float32)
    m = np.stack([m1, m1 * m1 + 0.1 * g.random(r, dtype=np.float32),
                  g.integers(0, 8, r).astype(np.float32)])
    mk = torch.as_tensor(m, device=cuda_device)
    var_k, fv_k = svgf.estimate_variance(mk, width=width, height=height)
    var_r, fv_r = svgf.estimate_variance(mk.cpu(), width=width,
                                         height=height)
    assert parity.close_fraction(var_r, var_k, 1e-6, 1e-7) >= 0.9999
    assert parity.close_fraction(fv_r, fv_k, 1e-6, 1e-7) >= 0.9999
    f2 = svgf.filter_variance(fv_k, width=width, height=height)
    f2_r = svgf.filter_variance(fv_k.cpu(), width=width, height=height)
    assert parity.close_fraction(f2_r, f2, 1e-6, 1e-7) >= 0.9999


@pytest.mark.parametrize("level", [0, 2, 4])
def test_b4_kernel_matches_twin(svgf_inputs, level):
    gb, color, prev = svgf_inputs
    var = prev[3].contiguous()
    fv = prev[4].contiguous()
    kw = dict(level=level, width=W, height=H, sig_l=1.0, sig_n=128.0,
              sig_d=4.0)
    before = atrous.svgf_launches
    ck, vk = atrous.atrous_svgf_cuda(color, var, fv, gb, **kw)
    assert atrous.svgf_launches == before + 1
    cr, vr = atrous.atrous_svgf_ref(color, var, fv, gb, **kw)
    assert parity.close_fraction(cr, ck, 1e-5, 1e-6) >= 0.999
    assert parity.close_fraction(vr[None], vk[None], 1e-5, 1e-6) >= 0.999


@pytest.fixture(scope="module")
def general(cuda_device):
    """Camera rays of a 256x64 frame of many_light_scene(16, 6), a quarter
    reversed (misses)."""
    arrays, camkw = many_light_scene(16, 6)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam = make_camera(**camkw)
    x, y = pixel_centers(W, H, cuda_device)
    half = torch.full_like(x, 0.5)
    o, d = sample_rays(cam, W, H, x, y, half, half)
    d = d.clone()
    d[::4] = -d[::4]
    return scene, cam, tix.traversal_arrays(scene), o.contiguous(), d


def test_b12_kernel_matches_twin(general):
    """B12's pack equals primary_ref's on the card bit for bit."""
    scene, _, trv, o, d = general
    before = ki.primary_launches
    k = ki.primary_cuda(trv, scene.prim_attr, scene.mat_attr, o, d)
    r = ki.primary_ref(trv, scene.prim_attr, scene.mat_attr, o, d)
    assert ki.primary_launches == before + 1
    assert torch.equal(k, r)
    miss = r[ki.CH_PRIM] < 0
    assert float(miss.float().mean()) > 0.2
    row0 = scene.mat_attr[0, :11]
    assert torch.equal(k[ki.CH_MAT:ki.CH_MAT + 11][:, miss],
                       row0[:, None].expand(-1, int(miss.sum())))


def test_b12_inactive_lanes_get_the_miss_pack(general):
    """Lanes outside `active` are not walked and get the pack of a miss,
    as primary_ref with the same mask writes it."""
    scene, _, trv, o, d = general
    active = torch.arange(R, device=o.device) % 3 != 0
    k = ki.primary_cuda(trv, scene.prim_attr, scene.mat_attr, o, d, active)
    r = ki.primary_ref(trv, scene.prim_attr, scene.mat_attr, o, d, active)
    assert torch.equal(k, r)
    full = ki.primary_cuda(trv, scene.prim_attr, scene.mat_attr, o, d)
    assert torch.equal(k[:, active], full[:, active])
    assert bool((full[ki.CH_PRIM][~active] >= 0).any())
    assert bool((k[ki.CH_PRIM][~active] == -1).all())
    assert bool(torch.isinf(k[ki.CH_DIST][~active]).all())


def test_b11_closest_kernel_matches_twin(general):
    """B11's closest hit equals intersect_bf's on the card: the primitive
    on every lane, dist and barycentrics on hits bit for bit."""
    scene, _, trv, o, d = general
    pk, dk, bk = ki.closest_cuda(trv, o, d)
    pr, dr, br = intersect_bf.intersect_closest_bf(trv.tri_xform, o, d)
    assert torch.equal(pk, pr)
    hit = pr >= 0
    assert torch.equal(dk[hit], dr[hit])
    assert torch.equal(bk[hit], br[hit])
    assert torch.all(torch.isinf(dk[~hit]))
    assert torch.all(bk[~hit] == 0.0)


def test_b11_b12_degenerate_rays_miss(general):
    """Zero and non-finite directions (a dead lane's ray) miss in B11 and
    B12, as in their twins: the walk never reaches a leaf test that
    hits."""
    scene, _, trv, o, d = general
    nan, inf = float("nan"), float("inf")
    bad = torch.tensor([[0.0, 0.0, 0.0], [nan, nan, nan], [nan, 0.0, 1.0],
                        [inf, 0.0, 0.0], [0.0, -inf, 0.0], [inf, -inf, 1.0]],
                       device=o.device)
    d = bad.repeat(R // bad.shape[0] + 1, 1)[:R].contiguous()
    prim, dist, bary = ki.closest_cuda(trv, o, d)
    pr, _, _ = intersect_bf.intersect_closest_bf(trv.tri_xform, o, d)
    assert bool((prim == -1).all()) and torch.equal(prim, pr)
    assert bool(torch.isinf(dist).all()) and bool((bary == 0.0).all())
    k = ki.primary_cuda(trv, scene.prim_attr, scene.mat_attr, o, d)
    assert torch.equal(k, ki.primary_ref(trv, scene.prim_attr,
                                         scene.mat_attr, o, d))


def _segments(trv, o, d):
    """Segments from the camera rays' hits to a point under the ceiling,
    live where the ray hit."""
    prim, dist, _ = ki.closest_cuda(trv, o, d)
    pos = o + d * torch.where(torch.isfinite(dist), dist, 1.0)[:, None]
    target = torch.tensor([0.0, 8.0, 0.0], device=o.device).expand_as(pos)
    return pos, target.contiguous(), prim >= 0


def test_b11_any_kernel_matches_twin(general):
    """B11's any hit equals test_occlusion_bf's on the card, every lane."""
    scene, _, trv, o, d = general
    pos, target, active = _segments(trv, o, d)
    occ = ki.any_cuda(trv, pos, target, active)
    ref = intersect_bf.test_occlusion_bf(trv.tri_xform, pos, target, active)
    assert torch.equal(occ, ref)
    assert bool(occ.any()) and not bool(occ[~active].any())


def test_b11_b12_walk_counts_match_lockstep_twin(general):
    """The COUNT builds' per-ray box and plane tests equal those of the
    lockstep walks with the same leaf test, and the counted builds write
    the same results as the plain ones."""
    scene, _, trv, o, d = general
    k, counts = ki.primary_cuda(trv, scene.prim_attr, scene.mat_attr, o, d,
                                stats=True)
    assert torch.equal(k, ki.primary_cuda(trv, scene.prim_attr,
                                          scene.mat_attr, o, d))
    *_, boxes, tris = bvh_walk.closest_walk(
        scene.bvh, tuple(o.T), tuple(d.T), plane=bvh_walk.gi_plane)
    assert torch.equal(counts[0], boxes) and torch.equal(counts[1], tris)
    pk, _, _, c11 = ki.closest_cuda(trv, o, d, stats=True)
    assert torch.equal(c11, counts)
    assert torch.equal(pk, k[ki.CH_PRIM].to(torch.int32))
    pos, target, active = _segments(trv, o, d)
    occ, c_any = ki.any_cuda(trv, pos, target, active, stats=True)
    assert torch.equal(occ, ki.any_cuda(trv, pos, target, active))
    so, sd, limit = intersect_bf.occlusion_ray(pos, target)
    _, boxes, tris = bvh_walk.occluded_walk(
        scene.bvh, tuple(so.T), tuple(sd.T), torch.where(active, limit, -1.0),
        torch.full((R,), -1, dtype=torch.int32, device=o.device),
        plane=bvh_walk.gi_plane)
    assert torch.equal(c_any[0], boxes) and torch.equal(c_any[1], tris)
    assert int(c_any[0][~active].max()) == 0
    assert float(tris.float().mean()) < scene.num_tris / 4


@pytest.mark.parametrize("tracer", [TracerType.PT_FULL,
                                    TracerType.PT_INDIRECT])
def test_pt_frames_equal_with_and_without_b12_mask(general, tracer,
                                                   monkeypatch):
    """Dead paths' rays are not walked by B12: the frames equal those of
    B12 walking every lane with the primitive and distance of dead lanes
    masked afterwards, bit for bit."""
    scene, cam, _, _, _ = general
    cfg = RenderConfig(width=W, height=H, tracer=tracer, trace_depth=5)

    def frames():
        state = renderer.init_state(cfg, cam, device=scene.verts.device)
        out = []
        for _ in range(2):
            state, frame = renderer.step(scene, state, cam, cfg)
            out.append(frame)
        return out

    masked = frames()
    real = ki.primary_hit
    dead = []

    def unmasked(trv, prim_attr, mat_attr, o, d, active=None, geom=None):
        prim, dist, *rest = real(trv, prim_attr, mat_attr, o, d, None, geom)
        if active is not None:
            dead.append(int((~active).sum()))
            prim = torch.where(active, prim, -1)
            dist = torch.where(active, dist, torch.inf)
        return (prim, dist, *rest)

    monkeypatch.setattr(ki, "primary_hit", unmasked)
    for a, b in zip(masked, frames()):
        assert torch.equal(a, b)
    assert len(dead) == 10 and min(dead) > 0
    assert float(masked[-1].mean()) > 0.0


def test_b10_kernel_matches_twin(general):
    scene, cam, _, _, _ = general
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI)
    from restir_tpu_torch.models import gbuffer as tgb

    gb, it, mat, ray_dir = tgb.render_gbuffer(scene, cam, cam, cfg, 5)
    wo = -ray_dir
    norm = torch.where(((mat.type != 2) & ((it.norm * wo).sum(-1) < 0))[
        ..., None], -it.norm, it.norm)
    shade = it.valid & (gb.prim_id != tgb.LIGHT_ID)
    pack = ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness, shade, it.prim_id)
    before = ris_cdf.launches
    k = ris_cdf.ris_cdf_cuda(pack, 5, scene.tables, scene.bvh)
    r = ris_cdf.ris_cdf_ref(pack, 5, scene.tables)
    assert ris_cdf.launches == before + 1
    s = shade
    pick = torch.all(k[0:3] == r[0:3], 0) & torch.all(
        torch.isclose(k[3:6], r[3:6], rtol=2e-4, atol=1e-5), 0)
    assert float(pick[s].float().mean()) >= 0.995
    ok = pick & s
    close = torch.isclose(k[ris_cdf.OUT_W][ok], r[ris_cdf.OUT_W][ok],
                          rtol=2e-4, atol=1e-7)
    assert float(close.float().mean()) >= 0.999
    assert torch.equal(k[ris_cdf.OUT_M], r[ris_cdf.OUT_M])


def test_b10_walk_matches_twin_at_1080p(cuda_device):
    """B10 on the headline scene's general G-buffer at 1920x1080: phase
    12's gates, and on every lane where kernel and twin pick the same
    winner the kernel's walk zeroes the weight exactly where the twin's
    every-row loop does."""
    from restir_tpu_torch.models import gbuffer as tgb

    arrays, camkw = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=1920, height=1080, tracer=TracerType.RESTIR_DI)
    gb, it, mat, ray_dir = tgb.render_gbuffer(scene, cam, cam, cfg, 1)
    wo = -ray_dir
    norm = torch.where(((mat.type != 2) & ((it.norm * wo).sum(-1) < 0))[
        ..., None], -it.norm, it.norm)
    shade = it.valid & (gb.prim_id != tgb.LIGHT_ID)
    pack = ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness, shade, it.prim_id)
    before = ris_cdf.launches
    k = ris_cdf.ris_cdf_cuda(pack, 1, scene.tables, scene.bvh)
    assert ris_cdf.launches == before + 1
    kc, counts = ris_cdf.ris_cdf_cuda(pack, 1, scene.tables, scene.bvh,
                                      stats=True)
    assert torch.equal(kc, k)
    r = ris_cdf.ris_cdf_ref(pack, 1, scene.tables)
    w_ = ris_cdf.OUT_W
    pick = torch.all(k[0:3] == r[0:3], 0) & torch.all(
        torch.isclose(k[3:6], r[3:6], rtol=2e-4, atol=1e-5), 0)
    assert float(pick[shade].float().mean()) >= 0.995
    ok = pick & shade
    close = torch.isclose(k[w_][ok], r[w_][ok], rtol=2e-4, atol=1e-7)
    assert float(close.float().mean()) >= 0.999
    assert float((k[ris_cdf.OUT_M] == r[ris_cdf.OUT_M]).float()
                 .mean()) >= 0.9999
    assert torch.equal(k[w_][ok] == 0.0, r[w_][ok] == 0.0)
    walked = counts[0] > 0
    assert bool(walked.any()) and bool((counts[1][~walked] == 0).all())


@pytest.mark.parametrize("tracer,per_frame", [
    (TracerType.PT_DIRECT, {"primary": 2, "any": 1, "ris": 0}),
    (TracerType.RESTIR_DI, {"primary": 1, "any": 0, "ris": 1}),
])
def test_general_step_launches(general, tracer, per_frame):
    scene, cam, _, _, _ = general
    cfg = RenderConfig(width=W, height=H, tracer=tracer)
    state = renderer.init_state(cfg, cam, device=scene.verts.device)
    before = (ki.primary_launches, ki.any_launches, ris_cdf.launches)
    state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    got = (ki.primary_launches - before[0], ki.any_launches - before[1],
           ris_cdf.launches - before[2])
    assert got == (per_frame["primary"], per_frame["any"], per_frame["ris"])
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.0


@pytest.fixture(scope="module")
def gi_world(cuda_device):
    from restir_tpu_torch.config import mat_flags

    arrays, camkw = cornell_box(block_materials=("metal", "glass"))
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                       **mat_flags(arrays))
    return scene, make_camera(**camkw), cfg


def _gi_in_pack(scene, cam, cfg, looper):
    from restir_tpu_torch.models import gbuffer as tgb
    from restir_tpu_torch.models import restir_gi

    gb, it, mat, d = tgb.render_gbuffer(scene, cam, cam, cfg, looper)
    return gb, it, restir_gi._build_gi_in_pack(it, mat, d)


def _lanes(a, b, rtol, atol):
    return float(torch.isclose(a, b, rtol=rtol, atol=atol).all(0).float()
                 .mean())


@pytest.mark.parametrize("depth", [1, 5])
def test_b8_kernel_matches_twin(gi_world, depth):
    """B8 rounds as its twin does on the card: lane for lane."""
    scene, cam, cfg = gi_world
    _, _, in_pack = _gi_in_pack(scene, cam, cfg, 5)
    kw = dict(depth=depth, single_sided=True,
              n_lights=int(scene.light_prob.shape[0]))
    before = gi.trace_launches
    k = gi.gi_trace_cuda(in_pack, 5, scene, **kw)
    r = gi.gi_trace_ref(in_pack, 5, scene, **kw)
    assert gi.trace_launches == before + 1
    lo = slice(gi.GO_LO, gi.GO_LO + 3)
    assert _lanes(k[lo], r[lo], 2e-3, 2e-4) >= 0.999
    for c in (gi.GO_NV, gi.GO_XS, gi.GO_NS):
        assert _lanes(k[c:c + 3], r[c:c + 3], 1e-3, 1e-4) >= 0.999
    assert _lanes(k[gi.GO_PDF:gi.GO_PDF + 1], r[gi.GO_PDF:gi.GO_PDF + 1],
                  2e-3, 1e-5) >= 0.999
    assert float((k[gi.GO_DELTA] == r[gi.GO_DELTA]).float().mean()) >= 0.999
    assert float(k[lo].mean()) > 0.0


def test_b8_walk_counts_match_lockstep_twin(gi_world):
    """B8's per-ray box and plane tests equal those of the lockstep GI
    walks over the rays its twin casts (kernel and twin take the same
    paths), on sampled lanes."""
    from _gi_rays import gi_twin_rays

    from restir_tpu_torch.models import restir_gi
    from restir_tpu_torch.ops import intersect_bf as ibf

    scene, cam, cfg = gi_world
    _, _, in_pack = _gi_in_pack(scene, cam, cfg, 5)
    kw = restir_gi.trace_kwargs(scene, cfg)
    _, counts = gi.gi_trace_cuda(in_pack, 5, scene, stats=True, **kw)
    _, rays = gi_twin_rays(in_pack, 5, scene, **kw)
    boxes = torch.zeros(R, dtype=torch.int32, device=in_pack.device)
    tris = torch.zeros_like(boxes)
    for kind, a, b, active in rays:
        lanes = torch.nonzero(active)[:, 0]
        if kind == "closest":
            *_, bx, tr = bvh_walk.closest_walk(
                scene.bvh, tuple(a[lanes].T), tuple(b[lanes].T),
                plane=bvh_walk.gi_plane)
        else:
            o, d, limit = ibf.occlusion_ray(a[lanes], b[lanes])
            _, bx, tr = bvh_walk.occluded_walk(
                scene.bvh, tuple(o.T), tuple(d.T), limit,
                torch.full_like(lanes, -1), plane=bvh_walk.gi_plane)
        boxes[lanes] += bx
        tris[lanes] += tr
    pix = torch.arange(0, R, 7, device=in_pack.device)
    assert float((counts[0][pix] == boxes[pix]).float().mean()) >= 0.99
    assert float((counts[1][pix] == tris[pix]).float().mean()) >= 0.99
    assert int(counts[2].max()) <= kw["depth"] and float(tris.sum()) > 0


def test_b1a_packs_equal_b6_b7_on_headline_scene(cuda_device):
    """B1a is B6 + B7's walks in one launch: its gb and rs packs equal
    theirs bit for bit on the headline scene."""
    arrays, camkw = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    cv0, cv1 = pack_camera(cam0, cuda_device), pack_camera(cam1, cuda_device)
    before = fused_di.launches
    gb, rs = fused_di.gbuffer_ris_cuda(cv1, cv0, 1, scene.tables,
                                       scene.bvh, width=W, height=H)
    assert fused_di.launches == before + 1
    gb6 = gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W, height=H)
    rs7 = reuse.candidates_cuda(gb6, 1, scene.tables, scene.bvh, width=W)
    assert torch.equal(gb, gb6)
    assert torch.equal(rs, rs7)
    assert float((gb[fused_di.G_PRIM] >= 0).float().mean()) > 0.5


def test_b9_kernel_matches_twin(gi_world):
    """Three frames of B9 and its twin on B8's packs and the same
    previous pack."""
    from restir_tpu_torch.models import restir_gi

    scene, cam, cfg = gi_world
    q = torch.zeros((gi.Q_CH, R), device=scene.verts.device)
    for f in range(3):
        gb, it, in_pack = _gi_in_pack(scene, cam, cfg, f)
        go = gi.gi_trace_cuda(in_pack, f, scene,
                              **restir_gi.trace_kwargs(scene, cfg))
        gq = restir_gi._gq_pack(gb, it)
        before = gi.resolve_launches
        ind_k, q_k = gi.gi_resolve_cuda(go, in_pack, gq, q, f)
        ind_r, q_r = gi.gi_resolve_ref(go, in_pack, gq, q, f)
        assert gi.resolve_launches == before + 1
        assert float((q_k[gi.Q_M] == q_r[gi.Q_M]).float().mean()) >= 0.9999
        assert _lanes(q_k[gi.Q_W:gi.Q_W + 1], q_r[gi.Q_W:gi.Q_W + 1], 1e-5,
                      1e-7) >= 0.9999
        assert _lanes(ind_k, ind_r, 1e-3, 1e-6) >= 0.9999
        q = q_k
    assert float(q[gi.Q_M].max()) == 3.0


@pytest.mark.parametrize("with_scene", [True, False])
def test_gi_step_launches(gi_world, with_scene):
    """The fused GI frame runs B1 (two launches), B2, B8 and B9 once; the
    general one (init_state without a scene) B12, B10 and B8."""
    scene, cam, cfg = gi_world
    state = renderer.init_state(cfg, cam, scene if with_scene else None,
                                device=scene.verts.device)
    counters = lambda: (fused_di.launches, spatial.launches,  # noqa: E731
                        gi.trace_launches, gi.resolve_launches,
                        ki.primary_launches, ris_cdf.launches,
                        ki.any_launches)
    before = counters()
    state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counters(), before))
    assert got == ((2, 1, 1, 1, 0, 0, 0) if with_scene
                   else (0, 0, 1, 0, 1, 1, 0))
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.0


def test_gi_fallback_warns_once_on_the_card(cuda_device):
    from restir_tpu_torch.config import mat_flags

    arrays, camkw = env_scene()
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                       has_env_map=True, **mat_flags(arrays))
    cam = make_camera(**camkw)
    renderer._warned_fallback.discard(cfg)
    with pytest.warns(UserWarning, match="gi_resolve_fused_eligible"):
        state = renderer.init_state(cfg, cam, scene, device=cuda_device)
    assert isinstance(state, renderer.RenderState)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        renderer.init_state(cfg, cam, scene, device=cuda_device)


@pytest.fixture(scope="module")
def walk(general):
    """The `general` frame's scene through the MTBVH walk (B13 / B14):
    camera rays, a quarter reversed, and segments from their hits."""
    scene, cam, _, o, d = general
    trv = tix.traversal_arrays(scene, "bvh")
    pos, target, active = _segments(trv._replace(method="brute"), o, d)
    return scene, cam, trv, o, d, pos, target, active


def test_b13_closest_kernel_matches_twin(walk):
    """B13's closest hit equals intersect_closest_bvh's on the card bit for
    bit on every lane (misses: prim -1, dist inf, bary 0), and lanes
    outside `active` are not walked."""
    _, _, trv, o, d, _, _, active = walk
    before = ki.mt_closest_launches
    pk, dk, bk = ki.mt_closest_cuda(trv, o, d)
    assert ki.mt_closest_launches == before + 1
    pr, dr, br = tix.intersect_closest_bvh(trv.walk, o, d)
    assert torch.equal(pk, pr) and torch.equal(dk, dr) and torch.equal(bk, br)
    assert 0.2 < float((pk < 0).float().mean()) < 0.9
    pa, da, ba = ki.mt_closest_cuda(trv, o, d, active)
    want = tix.intersect_closest_bvh(trv.walk, o, d, active)
    assert all(torch.equal(a, b) for a, b in zip((pa, da, ba), want))
    assert bool((pa[~active] == -1).all())
    assert all(torch.equal(a, b) for a, b in zip(
        ki.closest_hit(trv, o, d), (pk, dk, bk)))


def test_b13_any_kernel_matches_twin(walk):
    _, _, trv, _, _, pos, target, active = walk
    before = ki.mt_any_launches
    occ = ki.mt_any_cuda(trv, pos, target, active)
    assert ki.mt_any_launches == before + 1
    ref = tix.test_occlusion_bvh(trv.walk, pos, target, active)
    assert torch.equal(occ, ref)
    assert bool(occ.any()) and not bool(occ[~active].any())
    assert torch.equal(ki.any_hit(trv, pos, target, active), occ)


def test_b13_primary_kernel_matches_twin(walk):
    """B13's primary build writes primary_ref's pack (the walk's twin hit,
    then B12's interpolation) bit for bit, with and without a mask."""
    scene, _, trv, o, d, _, _, active = walk
    attr, mats = scene.prim_attr, scene.mat_attr
    before = ki.mt_primary_launches
    k = ki.mt_primary_cuda(trv, attr, mats, o, d)
    assert ki.mt_primary_launches == before + 1
    assert torch.equal(k, ki.primary_ref(trv, attr, mats, o, d))
    km = ki.mt_primary_cuda(trv, attr, mats, o, d, active)
    assert torch.equal(km, ki.primary_ref(trv, attr, mats, o, d, active))
    # the walk and the brute force agree on the primitive nearly everywhere
    bf = ki.primary_cuda(trv, attr, mats, o, d)
    assert float((bf[ki.CH_PRIM] == k[ki.CH_PRIM]).float().mean()) > 0.998


def test_b14_heatmap_matches_twin(walk):
    """B14's count equals intersect_visualize's on every pixel, in ray
    order and on 8x4-pixel warps (the frame, and a band from mid-row),
    its counting build too, and the COUNT builds of B13 / B14 agree."""
    _, _, trv, o, d, _, _, _ = walk
    before = ki.heatmap_launches
    cnt = ki.heatmap_cuda(trv, o, d)
    assert ki.heatmap_launches == before + 1
    assert torch.equal(cnt, tix.intersect_visualize(trv.walk, o, d))
    assert torch.equal(ki.heatmap_cuda(trv, o, d, geom=(W, 0)), cnt)
    assert torch.equal(ki.heatmap(trv, o, d, geom=(W, 0)), cnt)
    p0, n = 5 * W + 17, 9 * W + 3
    assert torch.equal(ki.heatmap_cuda(trv, o[p0:p0 + n], d[p0:p0 + n],
                                       geom=(W, p0)), cnt[p0:p0 + n])
    cnt_c, counts = ki.heatmap_cuda(trv, o, d, stats=True, geom=(W, 0))
    assert torch.equal(cnt_c, cnt)
    _, _, _, c13 = ki.mt_closest_cuda(trv, o, d, stats=True)
    assert torch.equal(counts, c13)
    assert bool((cnt <= counts[0]).all()) and int(cnt.max()) > 4


def test_b14_octant_walk_on_straddling_and_edge_rays(walk):
    """B14 runs the loop of each ray's octant: warps whose lanes take all
    eight octants, and direction components 0.0, -0.0 and +-1e-13, still
    give the twin's count on every lane; so do NaN and infinite
    components and infinite origins (a ray with a NaN component misses
    the root's box, as the twin's torch.minimum keeps the NaN), where
    B13's closest and any hit equal their twins too, and B14's walk
    counters equal B13's closest-hit walk's lane for lane."""
    _, _, trv, o, d, _, _, _ = walk
    lane = torch.arange(R, device=o.device)
    x, y = lane % W, lane // W
    octant = (x % 2) + 2 * (y % 2) + 4 * ((x // 2) % 2)
    sign = 1.0 - 2.0 * torch.stack([(octant >> k) & 1 for k in range(3)],
                                   1).to(torch.float32)
    ds = (d * sign).contiguous()
    for dd in (ds, d):
        de = dd.clone()
        de[0::7, 0] = 0.0
        de[1::7, 1] = -0.0
        de[2::7, 2] = 1e-13
        de[3::7, 0] = -1e-13
        de[4::7, 1:] = 0.0
        for rays in (dd, de):
            want = tix.intersect_visualize(trv.walk, o, rays)
            for geom in (None, (W, 0)):
                assert torch.equal(ki.heatmap_cuda(trv, o, rays, geom=geom),
                                   want)
    on, dn = o.clone(), d.clone()
    dn[0::6, 1] = float("nan")
    dn[1::6, 2] = float("inf")
    dn[2::6, 0] = -float("inf")
    on[3::6, 0] = float("inf")
    on[4::6, 2] = -float("inf")
    dn[5::12] = float("nan")
    cnt, c14 = ki.heatmap_cuda(trv, on, dn, stats=True, geom=(W, 0))
    assert torch.equal(cnt, tix.intersect_visualize(trv.walk, on, dn))
    assert torch.equal(ki.heatmap_cuda(trv, on, dn), cnt)
    assert bool((cnt[0::6] == 0).all()) and bool((cnt[5::12] == 0).all())
    *hit, c13 = ki.mt_closest_cuda(trv, on, dn, stats=True)
    want = tix.intersect_closest_bvh(trv.walk, on, dn)
    assert all(torch.equal(a, b) for a, b in zip(hit, want))
    assert torch.equal(c14, c13)
    assert int(c14[0].sum()) > 0
    x, y = on.contiguous(), (on + 3.0 * dn).contiguous()
    assert torch.equal(ki.mt_any_cuda(trv, x, y),
                       tix.test_occlusion_bvh(trv.walk, x, y))


# B13's closest hit (the sorted ray query) on batches of the `walk`
# frame's rays: name -> (first ray, rays, tiled copies); "every lane dead"
# masks every lane
B13_QUERY_BATCHES = {
    "one ray": (5 * W + 3, 1, 1),
    "below one warp": (77, 31, 1),
    "one below the sort's threshold": (300, ki.QUERY_SORT_MIN - 1, 1),
    "the sort's threshold": (300, ki.QUERY_SORT_MIN, 1),
    "one past the sort tile": (1000, 4097, 1),
    "frame": (0, R, 1),
    "not a multiple of the sort tile": (123, R - 123, 3),
    "every lane dead": (0, R, 1),
}


def _query_batch(walk, name):
    _, _, _, o, d, _, _, _ = walk
    first, r, copies = B13_QUERY_BATCHES[name]
    o, d = (t[first:first + r].repeat(copies, 1).contiguous() for t in (o, d))
    act = torch.arange(o.shape[0], device=o.device) % 5 != 0
    if name == "every lane dead":
        act = torch.zeros_like(act)
    return o, d, act


@pytest.mark.parametrize("name", list(B13_QUERY_BATCHES))
def test_b13_sorted_closest_hit_equals_twin(walk, name):
    """B13's closest hit (ray key, radix sort, the octant walk read
    through the permutation) writes intersect_closest_bvh's prim, dist
    and bary bits on every lane, with and without `active`; its counting
    build's box and triangle tests per ray equal those of B13's primary
    counting build (exact_closest_walk) on the same rays; each call
    counts one walk launch, one key launch and the sort's 1 + passes
    kernels (a batch under QUERY_SORT_MIN: the walk alone, in ray
    order)."""
    scene, _, trv, _, _, _, _, _ = walk
    o, d, act = _query_batch(walk, name)
    r = o.shape[0]
    sorts = int(r >= ki.QUERY_SORT_MIN)
    passes = ro.RAY_SORT_PASSES
    for active in (None, act):
        before = (ki.mt_closest_launches, ro.key_launches,
                  ro.sort_kernel_launches())
        got = ki.mt_closest_cuda(trv, o, d, active)
        torch.cuda.synchronize()
        assert (ki.mt_closest_launches - before[0],
                ro.key_launches - before[1],
                ro.sort_kernel_launches() - before[2]) == (
                    1, sorts, (1 + passes) * sorts)
        want = tix.intersect_closest_bvh(trv.walk, o, d, active)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got, want))
        *hit, counts = ki.mt_closest_cuda(trv, o, d, active, stats=True)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(hit, want))
        _, c13 = ki.mt_primary_cuda(trv, scene.prim_attr, scene.mat_attr, o,
                                    d, active, stats=True)
        assert torch.equal(counts, c13)
    if name == "every lane dead":
        assert bool((got[0] == -1).all()) and int(counts.sum()) == 0
    elif r > 100:
        assert bool((got[0] >= 0).any()) and bool((got[0] < 0).any())


def test_b13_closest_hit_over_the_sort_cap_walks_in_ray_order(
        walk, monkeypatch):
    """A batch of more rays than one sort takes (QUERY_SORT_MAX, the C
    sort's own cap) walks in ray order with no key or sort launch and the
    twin's bits; here the cap is lowered to 4,096 rays for a 4,097-ray
    batch, while the batch at the cap still sorts."""
    lib = ro._build.library()
    assert lib.restir_prof_sort_scratch(ro.SORT_MAX_KEYS) > 0
    assert lib.restir_prof_sort_scratch(ro.SORT_MAX_KEYS + 1) < 0
    assert ki.QUERY_SORT_MAX == ro.SORT_MAX_KEYS
    _, _, trv, _, _, _, _, _ = walk
    o, d, act = _query_batch(walk, "one past the sort tile")
    monkeypatch.setattr(ki, "QUERY_SORT_MAX", o.shape[0] - 1)
    for cut, sorts in ((0, 0), (1, 1)):
        oo, dd, aa = o[cut:].contiguous(), d[cut:].contiguous(), act[cut:]
        before = (ki.mt_closest_launches, ro.key_launches,
                  ro.sort_kernel_launches())
        got = ki.mt_closest_cuda(trv, oo, dd, aa)
        torch.cuda.synchronize()
        assert (ki.mt_closest_launches - before[0],
                ro.key_launches - before[1],
                ro.sort_kernel_launches() - before[2]) == (
                    1, sorts, (1 + ro.RAY_SORT_PASSES) * sorts)
        want = tix.intersect_closest_bvh(trv.walk, oo, dd, aa)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got, want))


def test_b13_sorted_closest_hit_on_straddling_and_edge_rays(walk):
    """The sorted closest hit on test_b14_octant_walk_on_straddling_and_
    edge_rays's rays: warps of all eight octants, components 0.0, -0.0
    and +-1e-13, NaN and infinite components and infinite origins; every
    lane equals the twin, its counts B13's primary counting build's, and
    the walk in ray order (no permutation) writes the same bits."""
    scene, _, trv, o, d, _, _, _ = walk
    lane = torch.arange(R, device=o.device)
    x, y = lane % W, lane // W
    octant = (x % 2) + 2 * (y % 2) + 4 * ((x // 2) % 2)
    sign = 1.0 - 2.0 * torch.stack([(octant >> k) & 1 for k in range(3)],
                                   1).to(torch.float32)
    ds = (d * sign).contiguous()
    de = ds.clone()
    de[0::7, 0] = 0.0
    de[1::7, 1] = -0.0
    de[2::7, 2] = 1e-13
    de[3::7, 0] = -1e-13
    de[4::7, 1:] = 0.0
    on, dn = o.clone(), de.clone()
    dn[0::6, 1] = float("nan")
    dn[1::6, 2] = float("inf")
    dn[2::6, 0] = -float("inf")
    on[3::6, 0] = float("inf")
    on[4::6, 2] = -float("inf")
    dn[5::12] = float("nan")
    for oo, dd in ((o, ds), (o, de), (on, dn)):
        *hit, counts = ki.mt_closest_cuda(trv, oo, dd, stats=True)
        want = tix.intersect_closest_bvh(trv.walk, oo, dd)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(hit, want))
        _, c13 = ki.mt_primary_cuda(trv, scene.prim_attr, scene.mat_attr,
                                    oo, dd, stats=True)
        assert torch.equal(counts, c13)
        unsorted = ki.mt_closest_walk(trv, oo, dd)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(unsorted, want))
    key = ro.ray_key(on, dn, None, trv.walk.rows)
    assert torch.equal(key, ro.ray_key_ref(on, dn, None, trv.walk.rows))
    assert int((key == ro.RAY_DEAD_KEY).sum()) == int(
        (torch.isnan(on).any(1) | torch.isnan(dn).any(1)).sum())


@pytest.mark.parametrize("tracer,per_frame", [
    (TracerType.PT_DIRECT, {"primary": 2, "any": 1, "heat": 0}),
    (TracerType.BVH_VISUALIZE, {"primary": 1, "any": 0, "heat": 1}),
])
def test_walk_step_launches(walk, tracer, per_frame):
    scene, cam, _, _, _, _, _, _ = walk
    cfg = RenderConfig(width=W, height=H, tracer=tracer, intersector="bvh")
    state = renderer.init_state(cfg, cam, device=scene.verts.device)
    before = (ki.mt_primary_launches, ki.mt_any_launches,
              ki.heatmap_launches, ki.primary_launches)
    state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    got = (ki.mt_primary_launches - before[0], ki.mt_any_launches - before[1],
           ki.heatmap_launches - before[2])
    assert got == (per_frame["primary"], per_frame["any"], per_frame["heat"])
    assert ki.primary_launches == before[3]
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.0


@pytest.mark.parametrize("denoiser", ["eaw", "svgf"])
def test_general_denoiser_step_matches_cpu_twin(walk, denoiser):
    """Three general RESTIR_DI frames with EAW or SVGF on the card (B3, or
    the variance kernels and B4) against the same frames of the CPU
    twins, from the same scene arrays."""
    from restir_tpu_torch.config import DenoiserType

    scene, cam, _, _, _, _, _, _ = walk
    arrays, _ = many_light_scene(16, 6)
    cpu_scene = convert.scene_from_numpy(arrays, "cpu")
    den = {"eaw": DenoiserType.EAW, "svgf": DenoiserType.SVGF}[denoiser]
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.PT_DIRECT,
                       denoiser=den)
    states = [renderer.init_state(cfg, cam, device=scene.verts.device),
              renderer.init_state(cfg, cam, device="cpu")]
    before = (atrous.launches, atrous.svgf_launches, svgf.variance_launches)
    for _ in range(3):
        states[0], fk = renderer.step(scene, states[0], cam, cfg)
        states[1], fr = renderer.step(cpu_scene, states[1], cam, cfg)
    got = (atrous.launches - before[0], atrous.svgf_launches - before[1],
           svgf.variance_launches - before[2])
    levels = cfg.eaw_levels
    # SVGF: the variance with level 0's prefilter (one launch), then the
    # prefilter of levels 1.. (one each)
    assert got == ((3 * levels, 0, 0) if denoiser == "eaw"
                   else (0, 3 * levels, 3 * levels))
    assert parity.close_fraction(fr.T, fk.cpu().T, 1e-4, 1e-6) >= 0.99


def test_b13_build_failure_raises(cuda_device, tmp_path, monkeypatch):
    """A source that nvcc refuses makes the build raise, naming it."""
    from restir_tpu_torch.ops.kernels import _build

    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.SRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (src / f.name).write_text(f.read_text())
    bad = src / "intersect.cu"
    bad.write_text(bad.read_text().replace("struct MtRay {",
                                           "struct MtRay { not_a_type x;"))
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="intersect.cu"):
        _build.build()


def test_b13_launch_errors_raise(walk):
    """A walk without its tables, or a launch the entry point refuses,
    raises instead of falling back."""
    _, _, trv, o, d, _, _, _ = walk
    with pytest.raises(ValueError, match="walk's tables"):
        ki.mt_closest_cuda(trv._replace(walk=None), o, d)
    empty = o[:0].contiguous()
    with pytest.raises(RuntimeError, match="restir_mt_closest_hit"):
        ki.mt_closest_cuda(trv, empty, empty)


def _bits(t):
    """t's bits, so that NaN lanes compare equal to NaN lanes."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


# B13 batches with geometry: name -> (width, pix0, first ray, rays) over
# the `walk` frame's 256x64 rays ("repeat" tiles them 128 times: 2,097,152
# rays, 8,192 tile blocks)
B13_BATCHES = {
    "frame": (W, 0, 0, R),
    "band of whole rows from mid-frame": (W, 24 * W, 24 * W, 16 * W),
    "width 100, ragged": (100, 0, 0, R),
    "mid-row band, width 100": (100, 237, 237, 5000),
    "below one warp": (W, 5 * W + 3, 5 * W + 3, 20),
    "repeat": (1920, 0, 0, 128 * R),
    "every lane inactive": (W, 0, 0, R),
    "zero and non-finite rays": (W, 0, 0, R),
}


def _b13_batch(walk, name):
    """(geometry, o, d, active, pos, target, seg_active) of a batch."""
    _, _, _, o, d, pos, target, seg = walk
    width, pix0, first, r = B13_BATCHES[name]
    act = torch.arange(R, device=o.device) % 5 != 0
    if name == "repeat":
        o, d, act, pos, target, seg = (
            t.repeat(128, *([1] * (t.dim() - 1)))
            for t in (o, d, act, pos, target, seg))
    o, d, act, pos, target, seg = (
        t[first:first + r].clone() for t in (o, d, act, pos, target, seg))
    if name == "every lane inactive":
        act = torch.zeros_like(act)
        seg = torch.zeros_like(seg)
    if name == "zero and non-finite rays":
        d[0:50] = 0.0
        o[50:100] = float("nan")
        d[100:150] = float("inf")
        o[150:200, 1] = float("-inf")
        target[0:50] = pos[0:50]
        pos[50:100] = float("nan")
        target[100:150] = float("inf")
        seg[:200] = True
    return (width, pix0), o, d, act, pos, target, seg


@pytest.mark.parametrize("name", list(B13_BATCHES))
def test_b13_tiled_launch_writes_the_twins_bits(walk, name):
    """B13's primary and any hit on 8x4-pixel warps write their twins'
    bits and the linear launch's on every lane: bands from mid-frame,
    ragged widths, a batch below one warp and one of 2,097,152 rays, every
    lane inactive, zero and non-finite rays."""
    scene = walk[0]
    trv = walk[2]
    attr, mats = scene.prim_attr, scene.mat_attr
    geom, o, d, act, pos, target, seg = _b13_batch(walk, name)
    before = (ki.mt_primary_launches, ki.mt_any_launches)
    k = ki.mt_primary_cuda(trv, attr, mats, o, d, act, geom=geom)
    occ = ki.mt_any_cuda(trv, pos, target, seg, geom=geom)
    assert (ki.mt_primary_launches, ki.mt_any_launches) == (
        before[0] + 1, before[1] + 1)
    lin = ki.mt_primary_cuda(trv, attr, mats, o, d, act)
    assert torch.equal(_bits(k), _bits(lin))
    assert torch.equal(occ, ki.mt_any_cuda(trv, pos, target, seg))
    if name == "repeat":  # the twins on the 16,384 rays it repeats
        n = R
        ref = ki.primary_ref(trv, attr, mats, o[:n], d[:n], act[:n])
        ref = ref.repeat(1, 128)
        occ_ref = tix.test_occlusion_bvh(trv.walk, pos[:n], target[:n],
                                         seg[:n]).repeat(128)
    else:
        ref = ki.primary_ref(trv, attr, mats, o, d, act)
        occ_ref = tix.test_occlusion_bvh(trv.walk, pos, target, seg)
    assert torch.equal(_bits(k), _bits(ref))
    assert torch.equal(occ, occ_ref)
    if name == "every lane inactive":
        assert bool((k[ki.CH_PRIM] == -1).all()) and not bool(occ.any())
    elif name in ("frame", "width 100, ragged", "repeat"):
        assert bool((k[ki.CH_PRIM] >= 0).any()) and bool(occ.any())


def test_b13_geometry_refused_on_the_card(walk):
    """A geometry that cannot hold the batch raises ValueError before any
    launch; a launch the entry point refuses raises through
    `_build.check`, with or without geometry (no fallback)."""
    scene, _, trv, o, d, pos, target, seg = walk
    attr, mats = scene.prim_attr, scene.mat_attr
    before = (ki.mt_primary_launches, ki.mt_any_launches)
    for geom in ((0, 0), (W, -1), (1, 0)):  # (1, 0): R rows > 65535 tiles
        with pytest.raises(ValueError, match="geometry"):
            ki.mt_primary_cuda(trv, attr, mats, o.repeat(33, 1),
                               d.repeat(33, 1), geom=geom)
        with pytest.raises(ValueError, match="geometry"):
            ki.mt_any_cuda(trv, pos.repeat(33, 1), target.repeat(33, 1),
                           geom=geom)
    assert (ki.mt_primary_launches, ki.mt_any_launches) == before
    empty = o[:0].contiguous()
    for geom in (None, (W, 0)):
        with pytest.raises(RuntimeError, match="restir_mt_primary_hit"):
            ki.mt_primary_cuda(trv, attr, mats, empty, empty, geom=geom)
        with pytest.raises(RuntimeError, match="restir_mt_any_hit"):
            ki.mt_any_cuda(trv, empty, empty, geom=geom)


@pytest.mark.parametrize("denoiser", ("EAW", "SVGF"))
def test_row_bands_on_one_card(cuda_device, denoiser):
    """The fused frame in 3 row bands on one card (384x16: the bands start
    mid-row) equals one band's bit for bit, and the CPU twins' banded
    frame within the slice's image gates."""
    from restir_tpu_torch import parallel
    from restir_tpu_torch.config import DenoiserType, mat_flags
    from restir_tpu_torch.models import restir_di_fused

    arrays, camkw = many_light_scene(16, 6)
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=384, height=16, tracer=TracerType.RESTIR_DI,
                       denoiser=getattr(DenoiserType, denoiser),
                       **mat_flags(arrays))
    out = {}
    for dev, n in ((cuda_device, 1), (cuda_device, 3), ("cpu", 3)):
        scene = convert.scene_from_numpy(arrays, dev)
        mesh = parallel.make_mesh([dev] * n)
        step = parallel.make_fused_sharded_step(cfg, mesh)
        scenes = parallel.shard_scene(scene, mesh)
        state = parallel.shard_fused_state(
            restir_di_fused.init_state(cfg, cam, dev), mesh)
        for _ in range(3):
            state, frame = step(scenes, state, cam)
        out[(str(dev), n)] = parallel.gather(frame, "cpu").numpy()
    card = str(cuda_device)
    assert np.array_equal(out[(card, 1)], out[(card, 3)])
    want, got = out[("cpu", 3)], out[(card, 3)]
    assert np.isfinite(got).all() and got.mean() > 0.0
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
    assert mean_rel < 0.01, mean_rel
    assert np.isclose(want, got, rtol=1e-3, atol=1e-6).mean() >= 0.99


def test_b10_band_launches_equal_the_whole_frame(general):
    """B10 on 4 row bands of 16 rows, each keyed by its first global
    pixel, writes the whole-frame launch's pack at the band's pixels bit
    for bit; at pix0 = 0 on the whole frame it writes what the launch
    without band arguments writes."""
    from restir_tpu_torch.models import gbuffer as tgb

    scene, cam, _, _, _ = general
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI)
    gb, it, mat, ray_dir = tgb.render_gbuffer(scene, cam, cam, cfg, 5)
    wo = -ray_dir
    norm = torch.where(((mat.type != 2) & ((it.norm * wo).sum(-1) < 0))[
        ..., None], -it.norm, it.norm)
    pack = ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness,
                               it.valid & (gb.prim_id != tgb.LIGHT_ID),
                               it.prim_id)
    whole = ris_cdf.ris_cdf_cuda(pack, 5, scene.tables, scene.bvh)
    assert torch.equal(ris_cdf.ris_cdf_cuda(pack, 5, scene.tables, scene.bvh,
                                            pix0=0), whole)
    r_loc = R // 4
    before = ris_cdf.launches
    for b in range(4):
        sl = slice(b * r_loc, (b + 1) * r_loc)
        band = ris_cdf.ris_cdf_cuda(pack[:, sl].contiguous(), 5,
                                    scene.tables, scene.bvh, pix0=b * r_loc)
        assert torch.equal(band, whole[:, sl]), b
    assert ris_cdf.launches == before + 4
    assert float(whole[ris_cdf.OUT_W].max()) > 0.0


def test_b9_band_launches_equal_the_whole_frame(gi_world):
    """Frame 1 of B9 after a moving camera, on 2 bands of 8 tiles: each
    band, given the range of the previous pack its motion reaches, writes
    the whole-frame launch's packs at its pixels bit for bit; at pix0 = 0
    with the whole previous pack it writes what the launch without band
    arguments writes."""
    from restir_tpu_torch.models import gbuffer as tgb
    from restir_tpu_torch.models import restir_gi
    from restir_tpu_torch.ops.camera import update_camera
    from restir_tpu_torch.parallel import sharding

    scene, cam, cfg = gi_world
    moved = update_camera(cam, position=(float(cam.position[0]) + 0.2,
                                         float(cam.position[1]) + 0.3,
                                         float(cam.position[2])))
    q = torch.zeros((gi.Q_CH, R), device=scene.verts.device)
    for f, (c, last) in enumerate(((cam, cam), (moved, cam))):
        gb, it, mat, d = tgb.render_gbuffer(scene, c, last, cfg, f)
        in_pack = restir_gi._build_gi_in_pack(it, mat, d)
        go = gi.gi_trace_cuda(in_pack, f, scene,
                              **restir_gi.trace_kwargs(scene, cfg))
        gq = restir_gi._gq_pack(gb, it)
        prev = q
        ind, q = gi.gi_resolve_cuda(go, in_pack, gq, q, f)
    ind0, q0 = gi.gi_resolve_cuda(go, in_pack, gq, prev, 1, pix0=0,
                                  prev_base=0, r_prev=R)
    assert torch.equal(ind0, ind) and torch.equal(q0, q)
    assert float(q[gi.Q_M].max()) == 2.0
    r_loc = R // 2
    before = gi.resolve_launches
    for b in range(2):
        sl = slice(b * r_loc, (b + 1) * r_loc)
        (lo, hi), = sharding.motion_ranges(
            [gb._replace(**{k: getattr(gb, k)[sl] for k in gb._fields})], R,
            scene.verts.device)
        assert (lo, hi) != (b * r_loc, (b + 1) * r_loc)
        ind_b, q_b = gi.gi_resolve_cuda(
            go[:, sl].contiguous(), in_pack[:, sl].contiguous(),
            gq[:, sl].contiguous(), prev[:, lo:hi].contiguous(), 1,
            pix0=b * r_loc, prev_base=lo, r_prev=R)
        assert torch.equal(ind_b, ind[:, sl]), b
        assert torch.equal(q_b, q[:, sl]), b
    assert gi.resolve_launches == before + 2


@pytest.mark.parametrize("case", ("di_svgf", "gi_pack"))
def test_general_row_bands_on_one_card(cuda_device, case):
    """The general frame in row bands on one card (4 bands of 16 rows for
    DI + SVGF with a moving camera, 2 of 8 B9 tiles for GI with the
    resolve pack) equals one band's bit for bit and
    `renderer.step_general`'s within rtol 1e-5 / atol 1e-6."""
    from restir_tpu_torch import parallel
    from restir_tpu_torch.config import DenoiserType, mat_flags
    from restir_tpu_torch.ops.camera import update_camera

    arrays, camkw = (many_light_scene(16, 6) if case == "di_svgf"
                     else cornell_box())
    scene = convert.scene_from_numpy(arrays, cuda_device)
    cam = make_camera(**camkw)
    pos = camkw["position"]
    cams = [cam, cam, update_camera(cam, position=(pos[0] + 0.2,
                                                   pos[1] + 0.3, pos[2]))]
    if case == "di_svgf":
        cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                           denoiser=DenoiserType.SVGF, **mat_flags(arrays))
        n = 4
    else:
        cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                           **mat_flags(arrays))
        n = 2
    out = {}
    for bands in (1, n):
        mesh = parallel.make_mesh([cuda_device] * bands)
        state = renderer.init_general(cfg, cam, cuda_device, scene)
        assert isinstance(state.gi_reservoir, torch.Tensor) == (
            case == "gi_pack")
        step = parallel.make_sharded_step(cfg, mesh, state)
        state = parallel.shard_state(state, mesh, cfg)
        frames = []
        for c in cams:
            state, frame = step(scene, state, c)
            frames.append(parallel.gather(frame, cuda_device, dim=0))
        out[bands] = frames
    state = renderer.init_general(cfg, cam, cuda_device, scene)
    for i, c in enumerate(cams):
        state, single = renderer.step_general(scene, state, c, cfg)
        assert torch.equal(out[n][i], out[1][i]), i
        torch.testing.assert_close(out[n][i], single, rtol=1e-5, atol=1e-6)
    assert float(out[n][-1].mean()) > 0.0


# ---- B7's light search and B10: light tables past shared memory


def _b10_input(scene, cam, w=W, h=H, looper=5):
    """B10's input pack on the general G-buffer and its shading lanes."""
    from restir_tpu_torch.models import gbuffer as tgb

    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI)
    gb, it, mat, ray_dir = tgb.render_gbuffer(scene, cam, cam, cfg, looper)
    wo = -ray_dir
    norm = torch.where(((mat.type != 2) & ((it.norm * wo).sum(-1) < 0))[
        ..., None], -it.norm, it.norm)
    shade = it.valid & (gb.prim_id != tgb.LIGHT_ID)
    return ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness, shade, it.prim_id), shade


def _b10_twin_gates(k, r, shade):
    """test_b10_kernel_matches_twin's gates."""
    pick = torch.all(k[0:3] == r[0:3], 0) & torch.all(
        torch.isclose(k[3:6], r[3:6], rtol=2e-4, atol=1e-5), 0)
    assert float(pick[shade].float().mean()) >= 0.995
    ok = pick & shade
    close = torch.isclose(k[ris_cdf.OUT_W][ok], r[ris_cdf.OUT_W][ok],
                          rtol=2e-4, atol=1e-7)
    assert float(close.float().mean()) >= 0.999
    assert torch.equal(k[ris_cdf.OUT_M], r[ris_cdf.OUT_M])


@pytest.mark.parametrize("k", [1, 4])
def test_streamed_search_matches_twin(ragged, env_tex, k):
    """The light search kernel alone (`_parts=1`; 128 rows on a ragged
    frame, 640 with the env tiles): each pixel evaluates the light
    targets its CPU mirror (`reuse.search_streamed`) evaluates, the
    mirror's picks equal the full row-order scan's on the same targets
    (`reuse.search_full`), every shading lane's candidate is the twin's
    (`fused_di.ris_all`: the same light point, its weight within rtol
    2e-4), and the walk after it changes only the weights of occluded
    winners."""
    for scene, gb, w, has_env in _b7_frames(ragged, env_tex):
        t = scene.tables
        kw = dict(width=w, k=k, has_env=has_env, stats=True)
        before = (reuse.search_launches, reuse.launches)
        rs, st = reuse.candidates_cuda(gb, 1, t, scene.bvh, _parts=1, **kw)
        assert (reuse.search_launches, reuse.launches) == (
            before[0] + 1, before[1])
        pix = torch.arange(gb.shape[1], device=gb.device)
        seg = reuse.seg_cuda(t.n_lights, has_env)
        idx, tq, total, evaluated = reuse.ris_search(
            gb, pix, 1, t, k=k, single_sided=True, has_env=has_env,
            seg=seg)
        assert torch.equal(st[2].long(), evaluated)
        targets, _ = reuse.search_targets(gb, t, single_sided=True,
                                          has_env=has_env)
        idx_f, tq_f, total_f = reuse.search_full(
            targets, reuse.thresholds(pix, 1, k, total))
        assert torch.equal(idx, idx_f)
        assert torch.equal(tq.view(torch.int32), tq_f.view(torch.int32))
        assert torch.equal(total.view(torch.int32),
                           total_f.view(torch.int32))
        li, wi, dist, wt = fused_di.ris_all(gb, pix, 1, t, k=k,
                                            single_sided=True, has_met=True,
                                            has_env=has_env)
        shade = gb[fused_di.G_SHADE] > 0.5
        assert bool(shade.any())
        assert torch.equal(rs[fused_di.RS_LI:fused_di.RS_LI + 3][:, shade],
                           li[:, shade])
        torch.testing.assert_close(
            rs[fused_di.RS_WI:fused_di.RS_WI + 3][:, shade], wi[:, shade],
            rtol=2e-4, atol=1e-5)
        torch.testing.assert_close(rs[fused_di.RS_W][shade], wt[shade],
                                   rtol=2e-4, atol=1e-7)
        full = reuse.candidates_cuda(gb, 1, t, scene.bvh, **kw)[0]
        w_ch = fused_di.RS_W
        assert torch.equal(full[:w_ch], rs[:w_ch])
        kept = full[w_ch] == rs[w_ch]
        assert bool((kept | (full[w_ch] == 0.0)).all())
        assert float(kept.float().mean()) > 0.5


@pytest.mark.parametrize("scales", [(2.0 ** -100,), (2.0 ** 80,),
                                    (2.0 ** -100, 2.0 ** 80)])
def test_search_off_the_fast_division_equals_b1(frame, scales):
    """Light rows whose psi column 13 (the light's power) is scaled by
    2^-100 or 2^80 give lit targets whose numerators leave [2^-60, 2^60],
    where the search's quotient leaves its fast path
    (`light_target4_fast`): their groups of 8 rows are added again
    through `light_target4`, in pass 1 and in the picks' re-scan. B6 +
    B7 + B1b still write B1's packs bit for bit (B1's targets divide
    correctly rounded on every row)."""
    scene, cv0, cv1, pt0 = frame
    t = scene.tables
    psi = t.psi.clone()
    # row 3 of groups 0, 2, ... of 8 rows takes scales[0], of groups 1,
    # 3, ... scales[1]; the other rows stay on the fast path
    for i, s in enumerate(scales):
        rows = torch.arange(3 + 8 * i, t.n_lights, 16)
        psi[rows, 13] *= s
    gb_b1, pt_b1 = fused_di.di_resident_cuda(
        cv1, cv0, 1, pt0, t._replace(psi=psi), scene.bvh, width=W, height=H)
    gb = gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W, height=H)
    # the unscaled numerators of lit rows lie in [2^-20, 2^20] here
    targets, _ = reuse.search_targets(gb, t, single_sided=True)
    assert float((targets[:, 3:t.n_lights:8] > 0).float().mean()) > 0.1
    t = t._replace(psi=psi)
    pt = reuse.reuse_cuda(gb, pt0, 1, t, scene.bvh, width=W)
    assert torch.equal(gb.view(torch.int32), gb_b1.view(torch.int32))
    assert torch.equal(pt.view(torch.int32), pt_b1.view(torch.int32))


@pytest.fixture(scope="module")
def many(cuda_device):
    """many_light_scene(1225, 24): 2,450 light rows, 2,748 triangles."""
    arrays, camkw = many_light_scene(1225, 24)
    scene = convert.scene_from_numpy(arrays, cuda_device)
    return arrays, scene, camkw


def test_b7_streamed_matches_twin_at_many_lights(many):
    """B7 on 2,450 light rows launches its search and its walk once each;
    with B1b it meets its twin under the pack gates, and each pixel
    evaluates between n_l and n_l + k * S light targets."""
    _, scene, camkw = many
    cv0 = pack_camera(make_camera(**camkw), scene.tables.psi.device)
    gb = gbuffer.gbuffer_cuda(cv0, cv0, 3, scene.bvh, width=W, height=H)
    prev = torch.zeros((fused_di.PT_CH, R), device=gb.device)
    before = (reuse.launches, reuse.search_launches)
    pt_k = reuse.reuse_cuda(gb, prev, 3, scene.tables, scene.bvh, width=W)
    assert (reuse.launches, reuse.search_launches) == (
        before[0] + 1, before[1] + 1)
    pt_r = reuse.reuse_ref(gb, prev, 3, scene.tables)
    fails, stats = parity.pt_report(pt_r, pt_k)
    assert not fails, (fails, stats)
    _, st = reuse.candidates_cuda(gb, 3, scene.tables, scene.bvh, width=W,
                                  stats=True)
    n_l = scene.tables.n_lights
    seg = reuse.seg_cuda(n_l, False)
    assert int(st[2].min()) >= n_l and int(st[2].max()) <= n_l + 4 * seg


def test_b10_matches_twin_at_many_lights(many):
    """B10 on 2,560 light rows (past the tables its first design staged)
    launches once and meets its twin under test_b10_kernel_matches_twin's
    gates."""
    _, scene, camkw = many
    pack, shade = _b10_input(scene, make_camera(**camkw))
    before = ris_cdf.launches
    k = ris_cdf.ris_cdf_cuda(pack, 5, scene.tables, scene.bvh)
    assert ris_cdf.launches == before + 1
    _b10_twin_gates(k, ris_cdf.ris_cdf_ref(pack, 5, scene.tables), shade)


@pytest.mark.parametrize("fused", [True, False])
def test_many_lights_renderer_step(many, fused):
    """Fused and general RESTIR_DI through renderer.step on 2,450 light
    rows: each frame launches B7 (fused) or B10 (general) once, and the
    light search once, and is finite and lit."""
    from restir_tpu_torch.config import mat_flags

    arrays, scene, camkw = many
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       **mat_flags(arrays))
    cam = make_camera(**camkw)
    state = renderer.init_state(cfg, cam, scene if fused else None,
                                device=scene.tables.psi.device)
    before = (reuse.launches, ris_cdf.launches, reuse.search_launches)
    for _ in range(3):
        state, frame = renderer.step(scene, state, cam, cfg)
    assert (reuse.launches - before[0], ris_cdf.launches - before[1],
            reuse.search_launches - before[2]) == (
        (3, 0, 3) if fused else (0, 3, 3))
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.0
