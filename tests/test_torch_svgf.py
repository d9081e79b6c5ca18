"""The port's SVGF against the JAX package's, on the CPU.

- B5's twin (`svgf.svgf_temporal_ref`) against
  `fused_di.svgf_temporal_pallas(interpret=True)` on a real G-buffer and a
  random history (rtol 1e-5, atol 1e-6, as tests/test_fused_di.py);
- the variance twins against `denoiser.svgf_estimate_variance` /
  `svgf_filter_variance` (rtol 1e-6), and the general SVGF chain's
  variance with level 0's prefilter from one call on its moments, at
  sizes that cut the kernels' tiles;
- B4's twin against `atrous_kernel.atrous_level_pallas(mode="svgf")` at
  levels 0-4 (rtol 2e-4, as tests/test_atrous.py);
- three RESTIR_DI + SVGF frames of the port's `step_fused` against the
  JAX `step_fused(interpret=True)` at 128x32 (the image gates of
  tests/test_torch_slice.py on the frame and on the svgf pack), and the
  SVGF state's init, reset and checkpoint in the JAX leaf layout.
Inputs come from numpy seeds; both sides read the same arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import denoiser as dn
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import atrous_kernel as ak
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import denoiser as tdn
from restir_tpu_torch.ops.kernels import atrous, svgf
from restir_tpu_torch.ops.kernels import fused_di as tk

W, H = 128, 32
R = W * H
G = R // 128


def _t(x):
    return torch.tensor(np.asarray(x))


def _image_gates(want, got):
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
    frac = np.isclose(want, got, rtol=1e-3, atol=1e-6).mean()
    return mean_rel, frac


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=6,
                                    bvh_impl="numpy")
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.SVGF, ris_mode="cdf",
                       **mat_flags(scene))
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, cfg, [cam0, cam0, cam1]


@pytest.fixture(scope="module")
def gb_pair(world):
    """Two consecutive G-buffers of the port's B1 twin (the camera moves
    between them), as numpy [GB_CH, R]."""
    _, tscene, cfg, cams = world
    cv0 = _t(fk.pack_camera(cams[0], W, H))
    cv1 = _t(fk.pack_camera(cams[2], W, H))
    zeros = torch.zeros(tk.PT_CH, R)
    gb0, _ = tk.di_resident(cv0, cv0, 0, zeros, tscene.tables, tscene.bvh,
                            width=W, height=H)
    gb1, _ = tk.di_resident(cv1, cv0, 1, zeros, tscene.tables, tscene.bvh,
                            width=W, height=H)
    return gb0.numpy(), gb1.numpy()


def test_layout_constants_match():
    for name in ("SV_COL", "SV_M1", "SV_M2", "SV_HIST", "SV_PRIM", "SV_NORM",
                 "SV_CH"):
        assert getattr(svgf, name) == getattr(fk, name), name
    assert tdn.SVGF_ALPHA == fk.SVGF_ALPHA == dn.SVGF_ALPHA
    assert tdn.SVGF_HISTORY_THRESHOLD == dn.SVGF_HISTORY_THRESHOLD
    assert np.array_equal(np.float32(tdn.GAUSSIAN_3), dn.GAUSSIAN_3)


def test_b5_twin_matches_pallas(gb_pair):
    gb0, gb1 = gb_pair
    g = np.random.default_rng(3)
    prev = g.random((fk.SV_CH, R), dtype=np.float32)
    prev[fk.SV_HIST] = g.integers(0, 9, R).astype(np.float32)
    prev[fk.SV_PRIM] = gb0[fk.G_PRIMR]  # the history of the last frame
    prev[fk.SV_NORM:fk.SV_NORM + 3] = gb0[fk.G_NORM:fk.G_NORM + 3]
    color = g.random((3, R), dtype=np.float32)
    want = np.asarray(fk.svgf_temporal_pallas(
        jnp.asarray(gb1.reshape(fk.GB_CH, G, 128)),
        jnp.asarray(color.reshape(3, G, 128)), jnp.asarray(prev),
        interpret=True)).reshape(fk.SV_CH, R)
    got = svgf.svgf_temporal(_t(gb1), _t(color), _t(prev)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the history really blended on most hit pixels, and reset elsewhere
    hit = gb1[fk.G_PRIMR] > -1.0
    assert (got[fk.SV_HIST][hit] > 0).mean() > 0.5
    assert (got[fk.SV_HIST][~hit] == 0).all()


def test_variance_twins_match_jax():
    g = np.random.default_rng(4)
    m1 = g.random((H, W), dtype=np.float32)
    m2 = (m1 * m1 + g.random((H, W), dtype=np.float32) * 0.1).astype(
        np.float32)
    hist = g.integers(0, 8, (H, W)).astype(np.float32)
    moments = np.stack([m1, m2, hist])
    want = np.asarray(dn.svgf_estimate_variance(jnp.asarray(moments)))
    got = tdn.svgf_estimate_variance(_t(moments)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (hist > 3.5).any() and (hist < 3.5).any()
    var = g.random((H, W), dtype=np.float32)
    want = np.asarray(dn.svgf_filter_variance(jnp.asarray(var)))
    got = tdn.svgf_filter_variance(_t(var)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the kernels' entry point reads the same planes from a pack's rows
    # and returns the level-0 prefilter beside the variance
    sv = np.zeros((fk.SV_CH, R), np.float32)
    sv[fk.SV_M1:fk.SV_M1 + 3] = moments.reshape(3, R)
    flat, fv0 = svgf.estimate_variance(_t(sv)[fk.SV_M1:fk.SV_M1 + 3],
                                       width=W, height=H)
    want = tdn.svgf_estimate_variance(_t(moments))
    np.testing.assert_array_equal(flat.numpy(), want.numpy().reshape(R))
    np.testing.assert_array_equal(
        fv0.numpy(), tdn.svgf_filter_variance(want).numpy().reshape(R))


@pytest.mark.parametrize("w,h", [(45, 13), (33, 9)])
def test_svgf_levels_fused_prefilter_matches_jax(monkeypatch, w, h):
    """svgf_levels (the general path's SVGF chain) takes the variance and
    level 0's prefilter from one call on its [3, R] moments, read in
    place as the [R, 3] history's transpose, and prefilters B4's
    variance before levels 1-4: at a size that is no multiple of the
    kernels' 32x8 tiles, each level's (variance, prefiltered variance)
    equals the JAX estimate followed by svgf_filter_variance (rtol
    1e-6)."""
    g = np.random.default_rng(40 + w)
    r = w * h
    m1 = g.random(r, dtype=np.float32)
    m2 = (m1 * m1 + g.random(r, dtype=np.float32) * 0.1).astype(np.float32)
    hist = g.integers(0, 8, r).astype(np.float32)
    history = np.stack([m1, m2, hist], axis=1)  # [R, 3], as SVGFState
    color = g.random((3, r), dtype=np.float32)
    pack = np.zeros((fk.GB_CH, r), np.float32)
    pack[fk.G_PRIMR] = g.integers(-1, 4, r)
    pack[fk.G_NORM:fk.G_NORM + 3] = g.normal(size=(3, r))
    pack[fk.G_POS:fk.G_POS + 3] = g.random((3, r))
    seen = []
    real = atrous.atrous_svgf_level

    def spy(c, var, fv, gb, **kw):
        seen.append((var.clone(), fv.clone()))
        return real(c, var, fv, gb, **kw)

    monkeypatch.setattr(atrous, "atrous_svgf_level", spy)
    cfg = tconfig.RenderConfig(width=w, height=h,
                               denoiser=tconfig.DenoiserType.SVGF)
    moment = _t(history).T
    assert not moment.is_contiguous()
    before = svgf.variance_launches
    tdn.svgf_levels(_t(color), moment, _t(pack), cfg)
    assert svgf.variance_launches == before  # the CPU runs the twins
    assert len(seen) == cfg.eaw_levels
    want = np.asarray(dn.svgf_estimate_variance(
        jnp.asarray(history.T.reshape(3, h, w))))
    for level, (var, fv) in enumerate(seen):
        if level == 0:
            np.testing.assert_allclose(var.numpy().reshape(h, w), want,
                                       rtol=1e-6, atol=1e-7)
        want_fv = np.asarray(dn.svgf_filter_variance(
            jnp.asarray(var.numpy().reshape(h, w))))
        np.testing.assert_allclose(fv.numpy().reshape(h, w), want_fv,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("level", range(5))
def test_b4_twin_matches_pallas(gb_pair, level):
    _, gb = gb_pair
    g = np.random.default_rng(10 + level)
    color = g.random((3, R), dtype=np.float32)
    var = (g.random(R, dtype=np.float32) * 0.05).astype(np.float32)
    fv = np.asarray(dn.svgf_filter_variance(
        jnp.asarray(var.reshape(H, W)))).reshape(R)
    guide = np.concatenate([gb[fk.G_PRIMR:fk.G_PRIMR + 1],
                            gb[fk.G_NORM:fk.G_NORM + 3],
                            gb[fk.G_POS:fk.G_POS + 3]])
    inp = np.concatenate([color, guide, var[None], fv[None]])
    kw = dict(sig_l=1.0, sig_n=128.0, sig_d=4.0)
    band = ak.pick_band(G, 1 << level, W // 128, ak.C_SVGF)
    want = np.asarray(ak.atrous_level_pallas(
        jnp.asarray(inp.reshape(ak.C_SVGF, G, 128)), mode="svgf",
        level=level, width=W, height=H, band=band, interpret=True,
        **kw)).reshape(4, R)
    got_c, got_v = atrous.atrous_svgf_level(
        _t(color), _t(var), _t(fv), _t(gb), level=level, width=W, height=H,
        **kw)
    np.testing.assert_allclose(got_c.numpy(), want[0:3], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), want[3], rtol=2e-4, atol=1e-6)


def _leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


@pytest.fixture(scope="module")
def jax_run(world, tmp_path_factory):
    """JAX leaves before and after each SVGF frame, the frames, and a
    checkpoint of the state after frame 1."""
    scene, _, cfg, cams = world
    state = jfused.init_state(cfg, cams[0])
    states, frames = [_leaves(state)], []
    ckpt = str(tmp_path_factory.mktemp("jax_svgf") / "state.npz")
    for i, cam in enumerate(cams):
        if i == 2:
            jrenderer.save_checkpoint(ckpt, state)
        state, frame = jfused.step_fused(scene, state, cam, cfg,
                                         interpret=True)
        states.append(_leaves(state))
        frames.append(np.asarray(frame).reshape(3, R))
    return states, frames, ckpt


def _port_cam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


def test_three_svgf_frames_match_jax(world, jax_run):
    _, tscene, cfg, cams = world
    states, jframes, _ = jax_run
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    state = convert.state_from_numpy(states[0], tcfg, "cpu")
    for i, cam in enumerate(cams):
        state, frame = trenderer.step(tscene, state, _port_cam(cam), tcfg)
        got = frame.numpy()
        assert got.shape == (3, R) and np.isfinite(got).all()
        mean_rel, frac = _image_gates(jframes[i], got)
        assert mean_rel < 0.01 and frac >= 0.99, (i, mean_rel, frac)
        sv_want = states[i + 1][4].reshape(fk.SV_CH, R)
        sv_got = state.svgf_pack.numpy()
        mean_rel, frac = _image_gates(sv_want, sv_got)
        assert mean_rel < 0.01 and frac >= 0.99, (i, mean_rel, frac)
    # the history grew where the surface stayed put
    assert float(state.svgf_pack[svgf.SV_HIST].max()) >= 2.0


def test_svgf_state_init_and_reset_match_jax(world, jax_run):
    _, tscene, cfg, cams = world
    states = jax_run[0]
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    state = trenderer.init_state(tcfg, _port_cam(cams[0]), tscene,
                                 device="cpu")
    leaves = convert.state_to_numpy(state)
    for want, got in zip(states[0], leaves):
        assert np.shape(want) == np.shape(got)
        assert np.array_equal(np.asarray(want), np.asarray(got))
    after = convert.state_from_numpy(states[2], tcfg, "cpu")
    reset = trenderer.reset_accumulation(after)
    want = _leaves(jfused.reset_accumulation(
        jax.tree.unflatten(jax.tree.structure(jfused.init_state(
            cfg, cams[0])), [jnp.asarray(x) for x in states[2]])))
    for a, b in zip(want, convert.state_to_numpy(reset)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_svgf_checkpoint_round_trip(world, jax_run, tmp_path):
    _, tscene, cfg, cams = world
    states, jframes, ckpt = jax_run
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    state = trenderer.load_checkpoint(ckpt, tcfg, _port_cam(cams[0]),
                                      tscene, device="cpu")
    assert np.array_equal(state.svgf_pack.numpy(),
                          states[2][4].reshape(fk.SV_CH, R))
    # the port writes the JAX leaf layout back, and reads its own file
    leaves = convert.state_to_numpy(state)
    assert [np.shape(x) for x in leaves] == [x.shape for x in states[2]]
    path = str(tmp_path / "port.npz")
    trenderer.save_checkpoint(path, state)
    back = trenderer.load_checkpoint(path, tcfg, _port_cam(cams[0]), tscene,
                                     device="cpu")
    assert torch.equal(back.svgf_pack, state.svgf_pack)
    # continuing from the loaded state reproduces the JAX third frame
    _, frame = trenderer.step(tscene, state, _port_cam(cams[2]), tcfg)
    mean_rel, frac = _image_gates(jframes[2], frame.numpy())
    assert mean_rel < 0.01 and frac >= 0.99, (mean_rel, frac)
