"""B10's MTBVH shadow walk against the brute force of its twin, on the CPU.

Kernel B10 (`csrc/ris_cdf.cu`) casts each live winner's shadow ray
through `csrc/bvh.cuh`'s any-hit walk with `plane_hit`, the leaf test of
its twin, whose `fused_di.shadow_pixels` tests every triangle row. Here
the winners are B10's own: `fused_di.ris_pixels` (B10's twin's RIS) on
the general G-buffer (`models.gbuffer.render_gbuffer`) of the headline
scene `many_light_scene(64, 24)` (426 triangles) and of
`many_light_scene(16, 120)` (1,482 triangles, over the resident limit)
at 128x64, for K = 1 and 4 candidates, single- and double-sided lights.
The lockstep walk of `ops/kernels/bvh_walk.py` with `di_plane` (the
CUDA walk's twin) takes the same rays: origin pushed 1e-5 along wi, the
limit dist (1 - 1e-3) - 1e-4, the pixel's own triangle excluded. Its
occlusion flags must equal those `shadow_pixels` zeroes on every lane,
and on the lanes B10 walks (a live winner) it must test fewer triangles
than a brute-force loop that stops at its first blocker.
"""

import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
from restir_tpu_torch.models import gbuffer as general_gb
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.ops.kernels import bvh_walk, fused_di, ris_cdf
from restir_tpu_torch.scene import procedural

W, H = 128, 64
LOOPER = 3


@pytest.fixture(scope="module", params=["headline", "large"])
def world(request):
    """(scene, config, B10's input pack as the gb view its twin reads)."""
    if request.param == "headline":
        arrays, camkw = procedural.many_light_scene(64, 24)
    else:
        arrays, camkw = procedural.many_light_scene(16, 120)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       **mat_flags(arrays))
    gbuf, it, mat, ray_dir = general_gb.render_gbuffer(scene, cam, cam, cfg,
                                                       LOOPER)
    wo = -ray_dir
    flip = (mat.type != 2) & ((it.norm * wo).sum(-1) < 0)
    shade = it.valid & (gbuf.prim_id != general_gb.LIGHT_ID)
    pack = ris_cdf.pack_inputs(
        it.pos, torch.where(flip[:, None], -it.norm, it.norm), wo, mat.type,
        mat.metallic, mat.roughness, shade, it.prim_id)
    return scene, cfg, ris_cdf._gb_view(pack)


def _first_blocker_tests(planes, n_tris, o, d, limit, prim):
    """Rows a loop over every triangle tests before its first blocker
    (every row when nothing blocks), per ray."""
    out = []
    ids = torch.arange(n_tris, dtype=torch.int32)[None, :]
    chunk = fused_di.chunk_pixels(n_tris)
    for p0 in range(0, d[0].shape[0], chunk):
        sl = slice(p0, p0 + chunk)
        oou, oov, oow, ddu, ddv, ddw = fused_di._hit_loop(
            planes[:n_tris], tuple(c[sl] for c in o), tuple(c[sl] for c in d))
        nondeg = torch.abs(ddw) >= 1e-12
        t = -oow / torch.where(nondeg, ddw, 1.0)
        u, v = oou + t * ddu, oov + t * ddv
        blocked = (nondeg & (t > 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
                   & (t < limit[sl][:, None]) & (ids != prim[sl][:, None]))
        out.append(torch.where(blocked.any(1),
                               blocked.int().argmax(1) + 1, n_tris))
    return torch.cat(out)


@pytest.mark.parametrize("single_sided", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_b10_walk_matches_brute_force(world, k, single_sided):
    scene, cfg, gb = world
    t = scene.tables
    _, wi, dist, w = fused_di.ris_pixels(
        gb, torch.arange(gb.shape[1]), LOOPER, t, k=k,
        single_sided=single_sided, has_met=cfg.scene_has_metallic)
    # the twin zeroes the weight of every occluded winner
    brute = fused_di.shadow_pixels(gb, wi, dist, torch.ones_like(w),
                                   t.planes) == 0.0
    o = tuple(gb[fused_di.G_POS + c] + wi[c] * 1e-5 for c in range(3))
    limit = dist * (1.0 - 1e-3) - 1e-4
    prim = gb[fused_di.G_PRIM].to(torch.int32)
    occ, boxes, tris = bvh_walk.occluded_walk(scene.bvh, o, tuple(wi), limit,
                                              prim, plane=bvh_walk.di_plane)
    assert torch.equal(occ, brute)
    live = w > 0.0  # the lanes B10 walks
    assert bool((occ & live).any()) and bool((~occ & live).any())
    assert bool((boxes[live] >= tris[live]).all())
    rows = _first_blocker_tests(t.planes, scene.num_tris, o, wi, limit, prim)
    assert int(tris[live].sum()) < int(rows[live].sum())
