"""Kernel-vs-twin checks of B1, B2, B3, B6 and B7 on a CUDA card.

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
from restir_tpu_torch.ops.kernels import (
    atrous,
    bvh_walk,
    fused_di,
    gbuffer,
    reuse,
    spatial,
)
from restir_tpu_torch.scene.procedural import many_light_scene

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
                                       width=W, height=H)
    return scene, cv0, cv1, pt0


@pytest.mark.parametrize("temporal", [True, False])
def test_b1_kernel_matches_twin(frame, temporal):
    scene, cv0, cv1, pt0 = frame
    kw = dict(width=W, height=H, temporal=temporal)
    gb_k, pt_k = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                           **kw)
    gb_r, pt_r = fused_di.di_resident_ref(cv1, cv0, 1, pt0, scene.tables,
                                          **kw)
    fails, stats = parity.gb_pt_report(gb_r, pt_r, gb_k, pt_k)
    assert not fails, (fails, stats)


def test_b2_kernel_matches_twin(frame):
    scene, cv0, cv1, pt0 = frame
    gb, pt = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                       width=W, height=H)
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
                                      width=W, height=H)
    color = torch.as_tensor(np.random.default_rng(1).random(
        (3, R), dtype=np.float32), device=gb.device)
    kw = dict(level=level, width=W, height=H, sig_l=1.0, sig_n=0.2,
              sig_d=64.0)
    k = atrous.atrous_level_cuda(color, gb, **kw)
    r = atrous.atrous_level_ref(color, gb, **kw)
    assert parity.close_fraction(r, k, 1e-5, 1e-6) >= 0.999


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
    pt_k = reuse.reuse_cuda(gb, prev, 3, scene.tables, scene.bvh, **kw)
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

    rs, st = reuse.candidates_cuda(gb, 3, scene.tables, scene.bvh,
                                   stats=True)
    wi = tuple(rs[fused_di.RS_WI + i] for i in range(3))
    o = tuple(gb[fused_di.G_POS + i] + wi[i] * 1e-5 for i in range(3))
    limit = rs[fused_di.RS_DIST] * (1.0 - 1e-3) - 1e-4
    _, boxes, tris = bvh_walk.occluded_walk(scene.bvh, o, wi, limit,
                                            gb[fused_di.G_PRIM])
    assert (boxes == st[0]).float().mean() >= 0.99
    assert (tris == st[1]).float().mean() >= 0.99


def test_mtbvh_path_matches_b1_on_resident_scene(frame):
    """B6 + B7 + B1b on a scene B1 renders resident agree with B1."""
    scene, cv0, cv1, pt0 = frame
    gb_b1, pt_b1 = fused_di.di_resident_cuda(cv1, cv0, 1, pt0, scene.tables,
                                             width=W, height=H)
    gb = gbuffer.gbuffer_cuda(cv1, cv0, 1, scene.bvh, width=W, height=H)
    pt = reuse.reuse_cuda(gb, pt0, 1, scene.tables, scene.bvh)
    fails, stats = parity.gb_pt_report(gb_b1, pt_b1, gb, pt)
    assert not fails, (fails, stats)
