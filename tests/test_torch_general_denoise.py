"""The general path's EAW and SVGF denoisers and the Sobol sampler
through `renderer.step`, against the JAX package's, on the CPU.

many_light_scene(8, 4) at 128x32 (the fused gate's width and height),
two denoiser levels, the camera moving on the last of three frames;
gates of
`tests/test_torch_general.py` (radiance within rtol 1e-4 on >= 99.5 % of
pixels):
- from a scene-less `init_state` (the general state): PT_DIRECT with EAW,
  RESTIR_DI with SVGF (SVGF history carried across the frames), PT_DIRECT
  with `sampler="sobol"`;
- from `init_state(cfg, cam, scene)` with a RESTIR_DI + EAW config that
  the fused gate takes, each change that sends it to the general path
  instead (PT_DIRECT, BVH_VISUALIZE, DoF, a width that is not a multiple
  of 128 (without the denoiser: JAX compiles its eager EAW anew for
  every frame size), the Sobol sampler): the port returns the general
  state, as the JAX package does off the TPU, and renders its frames;
- a general RESTIR_DI + SVGF `RenderState` checkpoint, SVGF history
  included, read by either package.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

from restir_tpu import renderer as jrenderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models.restir_di_fused import FusedDIState

W, H = 128, 32
# two à-trous levels: the level loop and the stride run as at five, and
# JAX compiles its eager filter anew for every stride (~6 s a level)
LEVELS = 2


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")
    camkw = {**camkw, "fov_y": 35.0}
    cam0 = make_camera(**camkw)
    pos = camkw["position"]
    cam1 = make_camera(**{**camkw, "position": (pos[0] + 0.3, pos[1],
                                                pos[2])})
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, [cam0, cam0, cam1]


def _tcam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


def _tcfg(cfg):
    return tconfig.RenderConfig(**dataclasses.asdict(cfg))


def _close_px(want, got, frac=0.995, rtol=1e-4, atol=1e-6):
    r = got.shape[0]
    want = np.asarray(want).reshape(r, -1)
    got = got.numpy().reshape(r, -1)
    assert np.isfinite(got).all()
    ok = np.isclose(want, got, rtol=rtol, atol=atol).all(-1).mean()
    assert ok >= frac, ok


def _steps(world, cfg, with_scene=False, frames=3):
    """`frames` frames of both renderers -> (JAX state, port state, port
    frame)."""
    scene, tscene, cams = world
    tcfg = _tcfg(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fallback notices
        jstate = jrenderer.init_state(cfg, cams[0],
                                      scene if with_scene else None)
        tstate = trenderer.init_state(tcfg, _tcam(cams[0]),
                                      tscene if with_scene else None,
                                      device="cpu")
    assert isinstance(jstate, jrenderer.RenderState)
    assert isinstance(tstate, trenderer.RenderState)
    for cam in cams[:frames]:
        jstate, jframe = jrenderer.step(scene, jstate, cam, cfg)
        tstate, tframe = trenderer.step(tscene, tstate, _tcam(cam), tcfg)
        assert tuple(tframe.shape) == (cfg.num_pixels, 3)
        _close_px(jframe, tframe)
    return jstate, tstate, tframe


STEP_CASES = {
    "pt_direct_eaw": dict(tracer=TracerType.PT_DIRECT,
                          denoiser=DenoiserType.EAW),
    "restir_di_svgf": dict(tracer=TracerType.RESTIR_DI,
                           denoiser=DenoiserType.SVGF),
    "pt_direct_sobol": dict(tracer=TracerType.PT_DIRECT, sampler="sobol"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_general_step_matches_jax(world, case):
    scene = world[0]
    cfg = RenderConfig(width=W, height=H, eaw_levels=LEVELS,
                       **mat_flags(scene), **STEP_CASES[case])
    jstate, tstate, frame = _steps(world, cfg)
    assert float(frame.mean()) > 0.0
    if cfg.denoiser == DenoiserType.SVGF:
        # the history is carried and equals the JAX one's
        hist = tstate.denoiser.accum_moment[:, 2]
        assert float(hist.max()) == 2.0
        _close_px(jstate.denoiser.accum_moment, tstate.denoiser.accum_moment)
        _close_px(jstate.denoiser.accum_color, tstate.denoiser.accum_color)


ROUTED = {
    "pt_direct": {"tracer": TracerType.PT_DIRECT},
    "bvh_visualize": {"tracer": TracerType.BVH_VISUALIZE},
    "dof": {"enable_dof": True},
    "width_100": {"width": 100, "denoiser": DenoiserType.NONE},
    "sobol": {"sampler": "sobol"},
}


@pytest.mark.parametrize("change", list(ROUTED))
def test_fused_refusals_render_on_the_general_path(world, change):
    """A fused RESTIR_DI + EAW config with one change the fused gate
    refuses: with the scene, both packages take the general path."""
    scene, tscene, cams = world
    base = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                        denoiser=DenoiserType.EAW, ris_mode="cdf",
                        eaw_levels=LEVELS, **mat_flags(scene))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fused = trenderer.init_state(_tcfg(base), _tcam(cams[0]), tscene,
                                     device="cpu")
    assert isinstance(fused, FusedDIState)
    _, _, frame = _steps(world, base.replace(**ROUTED[change]),
                         with_scene=True)
    assert float(frame.mean()) > 0.0


@pytest.fixture(scope="module")
def svgf_jax_state(world, tmp_path_factory):
    """A JAX RESTIR_DI + SVGF general state after two frames, its
    checkpoint and the JAX third frame from it."""
    scene, _, cams = world
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.SVGF, eaw_levels=LEVELS,
                       **mat_flags(scene))
    state = jrenderer.init_state(cfg, cams[0])
    for cam in cams[:2]:
        state, _ = jrenderer.step(scene, state, cam, cfg)
    path = str(tmp_path_factory.mktemp("svgf") / "general_svgf.npz")
    jrenderer.save_checkpoint(path, state)
    leaves = [np.array(x) for x in jax.tree.leaves(state)]
    _, frame = jrenderer.step(scene, state, cams[2], cfg)
    return cfg, path, leaves, np.asarray(frame)


def test_svgf_checkpoint_jax_to_port(world, svgf_jax_state):
    _, tscene, cams = world
    cfg, path, leaves, jframe = svgf_jax_state
    tcfg = _tcfg(cfg)
    state = trenderer.load_checkpoint(path, tcfg, _tcam(cams[0]),
                                      device="cpu")
    got = convert.render_state_to_numpy(state)
    assert len(got) == len(leaves)
    for want, g in zip(leaves, got):
        assert want.dtype == g.dtype and np.array_equal(want, g)
    assert float(state.denoiser.accum_moment[:, 2].max()) == 1.0
    _, frame = trenderer.step(tscene, state, _tcam(cams[2]), tcfg)
    _close_px(jframe, frame)


def test_svgf_checkpoint_port_to_jax(world, svgf_jax_state, tmp_path):
    scene, tscene, cams = world
    cfg = svgf_jax_state[0]
    tcfg = _tcfg(cfg)
    state = trenderer.init_state(tcfg, _tcam(cams[0]), device="cpu")
    for cam in cams[:2]:
        state, _ = trenderer.step(tscene, state, _tcam(cam), tcfg)
    path = str(tmp_path / "port_svgf.npz")
    trenderer.save_checkpoint(path, state)
    jstate = jrenderer.load_checkpoint(path, cfg, cams[0])
    for want, got in zip(convert.render_state_to_numpy(state),
                         jax.tree.leaves(jstate)):
        assert np.array_equal(want, np.asarray(got))
    _, jframe = jrenderer.step(scene, jstate, cams[2], cfg)
    _, frame = trenderer.step(tscene, state, _tcam(cams[2]), tcfg)
    _close_px(jframe, frame)
    reset = trenderer.reset_accumulation(state)
    assert float(reset.denoiser.accum_color.abs().sum()) == 0.0
    assert float(reset.denoiser.accum_moment.abs().sum()) == 0.0
