"""The port's general render path against the JAX package's, on the CPU.

many_light_scene(8, 4) at 64x32: the G-buffer pass, PT-direct, the full
path tracer, ReSTIR DI in cdf and reference mode, and `renderer.step`
over 3 frames for PT_DIRECT, PT_FULL, RESTIR_DI (both modes) and
GBUFFER_PREVIEW, port on the CPU against JAX on the CPU: radiance within
rtol 1e-4 on >= 99.5 % of pixels (a rare flipped shadow ray or BSDF
sample moves a pixel whole). Then `RenderState` checkpoints across the
two packages and the routing of `init_state`. The MTBVH intersector, the
heatmap, the denoisers and the Sobol sampler on this path are held in
`test_torch_general_walk.py` and `test_torch_general_denoise.py`.

The camera's fov is 35 degrees: at some angles XLA's float32 tan is one
ulp off the correctly rounded value that PyTorch returns, which would
move every primary ray by an ulp and turn the comparison into one of
edge cases.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import gbuffer as jgb
from restir_tpu.models import path_tracer as jpt
from restir_tpu.models import restir_di as jdi
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops import intersect as jix
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import gbuffer as tgb
from restir_tpu_torch.models import path_tracer as tpt
from restir_tpu_torch.models import restir_di as tdi
from restir_tpu_torch.models.restir_di_fused import FusedDIState
from restir_tpu_torch.ops import reservoir as trsv

W, H = 64, 32
R = W * H


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


def _cfg(scene, **kw):
    return RenderConfig(width=W, height=H, **mat_flags(scene), **kw)


def _close_px(want, got, frac=0.995, rtol=1e-4, atol=1e-6):
    want = np.asarray(want).reshape(R, -1)
    got = got.numpy().reshape(R, -1)
    assert np.isfinite(got).all()
    ok = np.isclose(want, got, rtol=rtol, atol=atol).all(-1).mean()
    assert ok >= frac, ok


def test_render_gbuffer_matches_jax(world):
    scene, tscene, cams = world
    cfg = _cfg(scene)
    gb, it, mat, d = jgb.render_gbuffer(scene, cams[2], cams[0], cfg,
                                        jnp.uint32(3))
    tgbuf, tit, tmat, td = tgb.render_gbuffer(tscene, _tcam(cams[2]),
                                              _tcam(cams[0]), _tcfg(cfg), 3)
    assert np.array_equal(np.asarray(gb.prim_id), tgbuf.prim_id.numpy())
    assert (np.asarray(gb.motion) == tgbuf.motion.numpy()).mean() >= 0.998
    for name in ("albedo", "norm", "depth", "pos"):
        _close_px(getattr(gb, name), getattr(tgbuf, name), frac=1.0,
                  rtol=1e-5, atol=1e-5)
    _close_px(d, td, frac=1.0, rtol=1e-6)
    assert np.array_equal(np.asarray(it.valid), tit.valid.numpy())
    assert np.array_equal(np.asarray(mat.type), tmat.type.numpy())


def test_pt_direct_matches_jax(world):
    scene, tscene, cams = world
    cfg = _cfg(scene, tracer=TracerType.PT_DIRECT)
    want = jpt.pt_direct(scene, cams[0], cfg, jnp.uint32(7))
    got = tpt.pt_direct(tscene, _tcam(cams[0]), _tcfg(cfg), 7)
    _close_px(want, got)
    assert float(got.mean()) > 0.0


def test_pt_trace_matches_jax(world):
    scene, tscene, cams = world
    cfg = _cfg(scene, tracer=TracerType.PT_FULL, trace_depth=4)
    wd, wi = jpt.pt_trace(scene, cams[0], cfg, jnp.uint32(2))
    gd, gi = tpt.pt_trace(tscene, _tcam(cams[0]), _tcfg(cfg), 2)
    _close_px(wd, gd)
    _close_px(wi, gi)
    assert float(gi.mean()) > 0.0


@pytest.mark.parametrize("ris_mode", ["cdf", "reference"])
def test_restir_direct_matches_jax(world, ris_mode):
    scene, tscene, cams = world
    cfg = _cfg(scene, ris_mode=ris_mode)
    tcfg = _tcfg(cfg)
    gb, it, mat, d = jgb.render_gbuffer(scene, cams[0], cams[0], cfg,
                                        jnp.uint32(4))
    out, res = jdi.restir_direct(
        scene, gb, jgb.empty_gbuffer(R), it, mat, d,
        jdi.rsv.zeros_direct(R), cfg, jnp.uint32(4))
    tgbuf, tit, tmat, td = tgb.render_gbuffer(tscene, _tcam(cams[0]),
                                              _tcam(cams[0]), tcfg, 4)
    tout, tres = tdi.restir_direct(
        tscene, tgbuf, tgb.empty_gbuffer(R, "cpu"), tit, tmat, td,
        trsv.zeros_direct(R, "cpu"), tcfg, 4)
    _close_px(out, tout)
    assert (np.asarray(res.m) == tres.m.numpy()).mean() >= 0.999
    _close_px(res.weight, tres.weight)


STEP_CASES = {
    "pt_direct": dict(tracer=TracerType.PT_DIRECT),
    "pt_full": dict(tracer=TracerType.PT_FULL),
    "restir_di_cdf": dict(tracer=TracerType.RESTIR_DI),
    "restir_di_reference": dict(tracer=TracerType.RESTIR_DI,
                                ris_mode="reference"),
    "gbuffer_preview": dict(tracer=TracerType.GBUFFER_PREVIEW),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_renderer_step_matches_jax(world, case):
    """Three frames through both renderers from a scene-less init_state
    (the general state), the camera moving on the last one."""
    scene, tscene, cams = world
    cfg = _cfg(scene, **STEP_CASES[case])
    tcfg = _tcfg(cfg)
    jstate = jrenderer.init_state(cfg, cams[0])
    tstate = trenderer.init_state(tcfg, _tcam(cams[0]), device="cpu")
    assert isinstance(tstate, trenderer.RenderState)
    for cam in cams:
        jstate, jframe = jrenderer.step(scene, jstate, cam, cfg)
        tstate, tframe = trenderer.step(tscene, tstate, _tcam(cam), tcfg)
        assert tuple(tframe.shape) == (R, 3)
        _close_px(jframe, tframe)
    assert tstate.looper == 3 and tstate.iteration == 3
    img = trenderer.frame_to_image(tframe, tcfg)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (H, W, 3)
    want = np.asarray(jrenderer.frame_to_image(jframe, cfg))
    assert (want == img.numpy()).mean() > 0.99


@pytest.fixture(scope="module")
def jax_states(world, tmp_path_factory):
    """A JAX RESTIR_DI RenderState after two frames, its checkpoint, and
    the JAX third frame from it."""
    scene, _, cams = world
    cfg = _cfg(scene)
    state = jrenderer.init_state(cfg, cams[0])
    for cam in cams[:2]:
        state, _ = jrenderer.step(scene, state, cam, cfg)
    path = str(tmp_path_factory.mktemp("general") / "jax_state.npz")
    jrenderer.save_checkpoint(path, state)
    leaves = [np.array(x) for x in jax.tree.leaves(state)]
    _, frame = jrenderer.step(scene, state, cams[2], cfg)
    return cfg, path, leaves, np.asarray(frame)


def test_checkpoint_jax_to_port(world, jax_states):
    _, tscene, cams = world
    cfg, path, leaves, jframe = jax_states
    tcfg = _tcfg(cfg)
    state = trenderer.load_checkpoint(path, tcfg, _tcam(cams[0]),
                                      device="cpu")
    assert isinstance(state, trenderer.RenderState)
    got = convert.render_state_to_numpy(state)
    assert len(got) == len(leaves)
    for want, g in zip(leaves, got):
        assert want.dtype == g.dtype and np.array_equal(want, g)
    _, frame = trenderer.step(tscene, state, _tcam(cams[2]), tcfg)
    _close_px(jframe, frame)


def test_checkpoint_port_to_jax(world, tmp_path):
    scene, tscene, cams = world
    cfg = _cfg(scene)
    tcfg = _tcfg(cfg)
    state = trenderer.init_state(tcfg, _tcam(cams[0]), device="cpu")
    for cam in cams[:2]:
        state, _ = trenderer.step(tscene, state, _tcam(cam), tcfg)
    path = str(tmp_path / "port_state.npz")
    trenderer.save_checkpoint(path, state)
    jstate = jrenderer.load_checkpoint(path, cfg, cams[0])
    assert isinstance(jstate, jrenderer.RenderState)
    for want, got in zip(convert.render_state_to_numpy(state),
                         jax.tree.leaves(jstate)):
        assert np.array_equal(want, np.asarray(got))
    back = trenderer.load_checkpoint(path, tcfg, _tcam(cams[0]),
                                     device="cpu")
    assert back.looper == 2 and back.iteration == 2
    assert torch.equal(back.dir_reservoir.weight, state.dir_reservoir.weight)
    reset = trenderer.reset_accumulation(back)
    assert reset.iteration == 0 and reset.looper == 2
    assert float(reset.direct_illum.abs().sum()) == 0.0


@pytest.fixture
def on_tpu(monkeypatch):
    """The JAX fused gate also asks for a TPU; answer yes, so its routing
    by resolution shows on the CPU."""
    monkeypatch.setattr(jix, "_on_tpu", lambda: True)


@pytest.mark.parametrize("size,fused", [((800, 800), False),
                                        ((1920, 1080), True)])
def test_routing_matches_jax(world, on_tpu, size, fused):
    scene, tscene, cams = world
    cfg = RenderConfig(width=size[0], height=size[1],
                       tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE, **mat_flags(scene))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX fallback warning
        jstate = jrenderer.init_state(cfg, cams[0], scene)
    tstate = trenderer.init_state(_tcfg(cfg), _tcam(cams[0]), tscene,
                                  device="cpu")
    assert isinstance(jstate, jfused.FusedDIState) == fused
    assert isinstance(tstate, FusedDIState) == fused
    assert isinstance(tstate, trenderer.RenderState) != fused


def test_init_state_without_scene_is_general(world):
    _, _, cams = world
    cfg = tconfig.RenderConfig(width=256, height=64)
    assert trenderer.init_state(cfg, _tcam(cams[0]), device="cpu").__class__ \
        is trenderer.RenderState
