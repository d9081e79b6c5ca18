"""The port's large-scene path against the JAX package's streaming kernels.

On many_light_scene(16, 120) (1482 triangles, over the 1024-triangle
resident limit) at 128x32, on the CPU:
- the G-buffer twin of kernel B6 (`gbuffer.gbuffer_ref`) against
  `fused_di.gbuffer_pack_pallas` (interpret mode), which takes its
  sub-block streaming kernel here;
- the reuse twin of kernel B7 + B1b (`reuse.reuse_ref`) against
  `fused_di.reuse_pallas` (wavefront-sorted visibility + merge kernels) on
  the JAX G-buffer and a random previous pack;
- three whole frames of the port's `renderer.step` against
  `restir_di_fused.step_fused(interpret=True)`.
Gates: the JAX package's own (restir_tpu_torch.parity) for the packs; the
frames hold a mean within 1 % and 99 % of values within rtol 1e-3 (a rare
RIS pick flip spreads through the spatial reuse, hence a fraction bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert, parity
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.ops.kernels import gbuffer, reuse

W, H = 128, 32
R = W * H


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=120,
                                    bvh_impl="numpy")
    assert scene.tri_xform.shape[1] // 3 > fk._RESIDENT_MAX_TRIS
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.EAW, ris_mode="cdf",
                       **mat_flags(scene))
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    assert tscene.num_tris > tfused.RESIDENT_MAX_TRIS
    return scene, tscene, cfg, [cam0, cam0, cam1]


def _tcam(cam):
    return torch.tensor(np.asarray(cam))


@pytest.fixture(scope="module")
def jax_gb(world):
    scene, _, cfg, cams = world
    cv = fk.pack_camera(cams[2], W, H)
    lcv = fk.pack_camera(cams[0], W, H)
    gb = fk.gbuffer_pack_pallas(
        cv, lcv, jnp.uint32(3), scene.tri_xform, scene.prim_attr,
        scene.mat_attr, scene.cluster_lo, scene.cluster_hi, scene.sub_lo,
        scene.sub_hi, width=W, height=H, aa_jitter=cfg.aa_jitter,
        single_sided=cfg.single_sided_lights, interpret=True)
    return cv, lcv, np.asarray(gb).reshape(fk.GB_CH, R)


def test_gbuffer_twin_matches_streaming_kernel(world, jax_gb):
    _, tscene, cfg, _ = world
    cv, lcv, gb_j = jax_gb
    gb_t = gbuffer.gbuffer_pack(_tcam(cv), _tcam(lcv), 3, tscene.bvh,
                                width=W, height=H, aa_jitter=cfg.aa_jitter,
                                single_sided=cfg.single_sided_lights)
    assert tuple(gb_t.shape) == (fk.GB_CH, R)
    fails, stats = parity.gb_report(gb_j, gb_t)
    assert not fails, (fails, stats)
    # interpret-mode parity: the same unit-plane test on the same rays
    assert stats["prim_match"] == 1.0, stats


def test_reuse_twin_matches_streaming_kernels(world, jax_gb):
    scene, tscene, cfg, _ = world
    _, _, gb_j = jax_gb
    prev = np.abs(np.random.default_rng(11).normal(
        size=(fk.PT_CH, R))).astype(np.float32)
    pt_j = fk.reuse_pallas(
        jnp.asarray(gb_j.reshape(fk.GB_CH, R // 128, 128)),
        jnp.asarray(prev), jnp.uint32(3),
        scene.light_verts, scene.light_normal, scene.light_radiance,
        scene.light_area, scene.light_center, scene.light_radius,
        scene.tri_xform, scene.cluster_lo, scene.cluster_hi,
        scene.sub_lo, scene.sub_hi, k=cfg.cdf_candidates,
        single_sided=cfg.single_sided_lights, temporal=True,
        temporal_clamp=cfg.temporal_clamp, has_met=cfg.scene_has_metallic,
        interpret=True)
    pt_t = reuse.reuse(torch.tensor(gb_j), torch.tensor(prev), 3,
                       tscene.tables, tscene.bvh, width=W,
                       k=cfg.cdf_candidates,
                       single_sided=cfg.single_sided_lights, temporal=True,
                       temporal_clamp=cfg.temporal_clamp,
                       has_met=cfg.scene_has_metallic)
    fails, stats = parity.pt_report(np.asarray(pt_j), pt_t)
    assert not fails, (fails, stats)


def test_three_frames_match_jax(world):
    scene, tscene, cfg, cams = world
    state = jfused.init_state(cfg, cams[0])
    leaves0 = [np.asarray(x) for x in jax.tree.leaves(state)]
    jframes = []
    for cam in cams:
        state, frame = jfused.step_fused(scene, state, cam, cfg,
                                         interpret=True)
        jframes.append(np.asarray(frame).reshape(3, R))

    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    tstate = convert.state_from_numpy(leaves0, tcfg, "cpu")
    for i, cam in enumerate(cams):
        tcam = convert.camera_from_numpy([np.asarray(x) for x in cam])
        tstate, frame = trenderer.step(tscene, tstate, tcam, tcfg)
        got, want = frame.numpy(), jframes[i]
        assert got.shape == (3, R) and np.isfinite(got).all()
        mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
        frac = np.isclose(want, got, rtol=1e-3, atol=1e-6).mean()
        assert mean_rel < 0.01, (i, mean_rel)
        assert frac >= 0.99, (i, frac)
    pt_j = np.asarray(state.pt_pack).reshape(fk.PT_CH, R)
    fails, stats = parity.pt_report(pt_j, tstate.pt_pack)
    assert not fails, (fails, stats)
