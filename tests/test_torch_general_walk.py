"""The general path's MTBVH intersector and BVH heatmap through
`renderer.step`, against the JAX package's, on the CPU.

Three frames through both renderers from a scene-less `init_state` (the
general state), the camera moving on the last one, as
`tests/test_torch_general.py` runs them and with its gates (radiance
within rtol 1e-4 on >= 99.5 % of pixels):
- many_light_scene(8, 4) at 64x32 with `intersector="bvh"`: PT_DIRECT,
  PT_FULL, RESTIR_DI in cdf and reference mode; RESTIR_DI with
  "clustered" (the JAX package walks the MTBVH for every name but
  "brute"); BVH_VISUALIZE with "auto" (brute force, the heatmap walks
  all the same), and the heatmap's counts with "auto" and "bvh";
- many_light_scene(8, 1400) (16,826 triangles) at 16x8: PT_DIRECT with
  "brute" (brute force at any size) and "auto" (the walk, with the
  warning).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import RenderConfig, TracerType, mat_flags
from restir_tpu.models import path_tracer as jpt
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import path_tracer as tpt


def _world(blocks):
    scene, camkw = many_light_scene(n_lights=8, n_blocks=blocks,
                                    bvh_impl="numpy")
    camkw = {**camkw, "fov_y": 35.0}
    cam0 = make_camera(**camkw)
    pos = camkw["position"]
    cam1 = make_camera(**{**camkw, "position": (pos[0] + 0.3, pos[1],
                                                pos[2])})
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, [cam0, cam0, cam1]


@pytest.fixture(scope="module")
def small():
    return _world(4)


@pytest.fixture(scope="module")
def large():
    return _world(1400)


def _tcam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


def _close_px(want, got, frac=0.995, rtol=1e-4, atol=1e-6):
    r = got.shape[0]
    want = np.asarray(want).reshape(r, -1)
    got = got.numpy().reshape(r, -1)
    assert np.isfinite(got).all()
    ok = np.isclose(want, got, rtol=rtol, atol=atol).all(-1).mean()
    assert ok >= frac, ok


def _steps(world, w, h, **kw):
    """Three frames of both renderers; returns the port's last frame."""
    scene, tscene, cams = world
    cfg = RenderConfig(width=w, height=h, **mat_flags(scene), **kw)
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    jstate = jrenderer.init_state(cfg, cams[0])
    tstate = trenderer.init_state(tcfg, _tcam(cams[0]), device="cpu")
    assert isinstance(tstate, trenderer.RenderState)
    for cam in cams:
        jstate, jframe = jrenderer.step(scene, jstate, cam, cfg)
        tstate, tframe = trenderer.step(tscene, tstate, _tcam(cam), tcfg)
        assert tuple(tframe.shape) == (w * h, 3)
        _close_px(jframe, tframe)
    assert tstate.looper == 3 and tstate.iteration == 3
    return tframe


SMALL_CASES = {
    "pt_direct_bvh": dict(tracer=TracerType.PT_DIRECT, intersector="bvh"),
    "pt_full_bvh": dict(tracer=TracerType.PT_FULL, intersector="bvh"),
    "restir_di_cdf_bvh": dict(tracer=TracerType.RESTIR_DI,
                              intersector="bvh"),
    "restir_di_reference_bvh": dict(tracer=TracerType.RESTIR_DI,
                                    ris_mode="reference", intersector="bvh"),
    "restir_di_clustered": dict(tracer=TracerType.RESTIR_DI,
                                intersector="clustered"),
    "bvh_visualize": dict(tracer=TracerType.BVH_VISUALIZE),
}


@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_walk_step_matches_jax(small, case):
    frame = _steps(small, 64, 32, **SMALL_CASES[case])
    assert float(frame.mean()) > 0.0


@pytest.mark.parametrize("intersector", ["auto", "bvh"])
def test_bvh_heatmap_matches_jax(small, intersector):
    """The heatmap's counts themselves, lane for lane."""
    scene, tscene, cams = small
    cfg = RenderConfig(width=64, height=32, tracer=TracerType.BVH_VISUALIZE,
                       intersector=intersector)
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jpt.bvh_heatmap(scene, cams[2], cfg))
    got = tpt.bvh_heatmap(tscene, _tcam(cams[2]), tcfg)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


LARGE_CASES = {
    "pt_direct_brute": dict(tracer=TracerType.PT_DIRECT,
                            intersector="brute"),
    "pt_direct_auto": dict(tracer=TracerType.PT_DIRECT),
}


@pytest.mark.parametrize("case", list(LARGE_CASES))
def test_large_scene_step_matches_jax(large, case):
    """Above 16,384 triangles: brute force on request, else the walk,
    with the JAX package's warning on both sides."""
    kw = LARGE_CASES[case]
    auto = kw.get("intersector", "auto") == "auto"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        frame = _steps(large, 16, 8, **kw)
    ours = [w for w in caught if "lockstep-BVH walk (kernel B13" in
            str(w.message)]
    assert bool(ours) == auto
    assert float(frame.mean()) > 0.0
