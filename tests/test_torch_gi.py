"""The port's ReSTIR GI trace and general GI step against the JAX
package's, on the CPU.

cornell_box() at 128x32 with the `lambert` and `metal_glass` blocks of
tests/test_gi_fused.py, the same primary hits (JAX's, converted) and the
same pcg4d streams on both sides:

- the torch `trace_gi_sample` against JAX `trace_gi_sample` (its XLA
  bounce loop) at depth 1, under test_gi_trace_depth1_exact's gates on
  every lane, and at depth 5. The two differ only where XLA's CPU sin /
  cos round a BSDF direction one ulp off PyTorch's; measured: Lo within
  rtol 2e-3 on all but 1 of 4,096 lanes at depth 5, everything else on
  every lane;
- B8's twin `gi_trace_ref` against JAX `trace_gi_sample_fused(...,
  interpret=True)` (the Pallas kernel), under test_gi_trace_matches_xla's
  gates and the fractions measured here;
- the general `restir_indirect` and `renderer.step` on a general
  RESTIR_GI state, three frames, against the JAX functions;
- routing (fused, general with the resolve pack, general with a
  reservoir), the fallback notice, `render` with no frames, and GI
  checkpoints both ways, JAX-written files included.

The Pallas trace in interpret mode is the slow part: it runs once per
scene, in a module fixture.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import RenderConfig, TracerType, mat_flags
from restir_tpu.models import gbuffer as jgb
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.models import restir_gi as jgi
from restir_tpu.ops import intersect as jix
from restir_tpu.ops import reservoir as jrsv
from restir_tpu.ops.camera import make_camera
from restir_tpu.scene import procedural
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import gbuffer as tgb
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.models import restir_gi as tgi
from restir_tpu_torch.ops import reservoir as trsv
from restir_tpu_torch.ops.bsdf import SurfaceMaterial
from restir_tpu_torch.ops.kernels import gi as tk
from restir_tpu_torch.ops.surface import Interaction

W, H = 128, 32
R = W * H


def _t(x):
    return torch.tensor(np.asarray(x))


def _tcfg(cfg):
    return tconfig.RenderConfig(**dataclasses.asdict(cfg))


def _tcam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


def _cfg(**kw):
    kw.setdefault("width", W)
    kw.setdefault("height", H)
    kw.setdefault("tracer", TracerType.RESTIR_GI)
    return RenderConfig(**kw)


def _frac(want, got, rtol, atol, mask=None):
    """Share of lanes whose every component agrees."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ok = np.isclose(np.asarray(want), got, rtol=rtol, atol=atol)
    if ok.ndim > 1:
        ok = ok.all(-1)
    if mask is not None:
        ok = ok[mask]
    return float(ok.mean())


@pytest.fixture(scope="module", params=["lambert", "metal_glass"])
def world(request):
    kw = {}
    if request.param == "metal_glass":
        kw["block_materials"] = ("metal", "glass")
    scene, camkw = procedural.cornell_box(bvh_impl="numpy", **kw)
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, make_camera(**camkw)


def _primary(scene, cam, cfg, looper):
    """JAX's primary hit and its port counterpart (the same arrays)."""
    gb, it, mat, d = jgb.render_gbuffer(scene, cam, cam, cfg,
                                        jnp.uint32(looper))
    tit = Interaction(valid=_t(it.valid), prim_id=_t(it.prim_id),
                      mat_id=_t(it.mat_id), pos=_t(it.pos), norm=_t(it.norm),
                      uv=_t(it.uv))
    tmat = SurfaceMaterial(type=_t(mat.type), base_color=_t(mat.base_color),
                           metallic=_t(mat.metallic),
                           roughness=_t(mat.roughness), ior=_t(mat.ior))
    return (gb, it, mat, d), (tit, tmat, _t(d))


def test_trace_depth1_matches_jax(world):
    """test_gi_trace_depth1_exact's gates, every lane."""
    scene, tscene, cam = world
    cfg = _cfg(aa_jitter=False, trace_depth=1)
    (_, it, mat, d), (tit, tmat, td) = _primary(scene, cam, cfg, 3)
    js, jpdf, jdelta, jvalid = jgi.trace_gi_sample(
        scene, it, mat, d, cfg, jnp.uint32(3), jnp.arange(R, dtype=jnp.uint32))
    ts, tpdf, tdelta, tvalid = tgi.trace_gi_sample(tscene, tit, tmat, td,
                                                   _tcfg(cfg), 3)
    valid = np.asarray(jvalid)
    assert np.array_equal(valid, tvalid.numpy())
    assert np.array_equal(np.asarray(jdelta), tdelta.numpy())
    for name, a, b, rtol, atol, mask in (
            ("lo", js.lo, ts.lo, 1e-4, 1e-6, None),
            ("pdf", jpdf, tpdf, 1e-3, 1e-6, None),
            ("nv", js.nv, ts.nv, 1e-4, 1e-6, None),
            ("xs", js.xs, ts.xs, 1e-3, 1e-4, valid),
            ("ns", js.ns, ts.ns, 1e-5, 1e-6, valid)):
        assert _frac(a, b, rtol, atol, mask) == 1.0, name
    assert valid.sum() > 5  # some first bounces reach the light


def test_trace_depth5_matches_jax(world):
    """test_gi_trace_matches_xla's quantities, held to the fractions
    measured here (one lane of 4,096 rerouted by an ulp)."""
    scene, tscene, cam = world
    cfg = _cfg(aa_jitter=False)
    (_, it, mat, d), (tit, tmat, td) = _primary(scene, cam, cfg, 5)
    js, jpdf, jdelta, jvalid = jgi.trace_gi_sample(
        scene, it, mat, d, cfg, jnp.uint32(5), jnp.arange(R, dtype=jnp.uint32))
    ts, tpdf, tdelta, tvalid = tgi.trace_gi_sample(tscene, tit, tmat, td,
                                                   _tcfg(cfg), 5)
    assert _frac(js.lo, ts.lo, 2e-3, 2e-4) >= 0.9995
    assert _frac(js.lo, ts.lo, 1e-5, 1e-7) >= 0.999
    ref = np.asarray(js.lo).mean()
    assert abs(float(ts.lo.mean()) - ref) / ref < 1e-4
    assert _frac(jpdf, tpdf, 2e-3, 1e-5) >= 0.9995
    assert (np.asarray(jdelta) == tdelta.numpy()).mean() >= 0.9995
    assert (np.asarray(jvalid) == tvalid.numpy()).mean() >= 0.9995
    for a, b in ((js.xs, ts.xs), (js.ns, ts.ns)):
        assert _frac(a, b, 1e-3, 1e-4) >= 0.9995
    assert _frac(js.nv, ts.nv, 1e-4, 1e-5) == 1.0
    assert tvalid.float().mean() > 0.1


@pytest.fixture(scope="module")
def pallas_trace(world):
    """JAX's fused trace (the Pallas kernel in interpret mode) and the
    port twin's, at depth 5 on the same IN pack."""
    scene, tscene, cam = world
    cfg = _cfg(aa_jitter=False)
    (_, it, mat, d), (tit, tmat, td) = _primary(scene, cam, cfg, 5)
    want = jgi.trace_gi_sample_fused(scene, it, mat, d, cfg, jnp.uint32(5),
                                     0, interpret=True)
    in_pack = tgi._build_gi_in_pack(tit, tmat, td)
    go = tk.gi_trace_ref(in_pack, 5, tscene, depth=5, single_sided=True,
                         n_lights=int(tscene.light_prob.shape[0]))
    return want, go, tgi._sample_from_go(go, tit.pos)


def test_trace_twin_matches_pallas(world, pallas_trace):
    """B8's twin against the TPU kernel: test_gi_trace_matches_xla's
    gates (the kernel's FMA hit tests and its light-point formula round
    apart from the twin's), and the fractions measured here."""
    (js, jpdf, jdelta, jvalid), go, (ts, tpdf, tdelta, tvalid) = pallas_trace
    assert tuple(go.shape) == (tk.GO_CH, R)
    assert float(go[tk.GO_DELTA + 1:].abs().max()) == 0.0
    lo_match = _frac(js.lo, ts.lo, 2e-3, 2e-4)
    assert lo_match > 0.97 and lo_match >= 0.999
    ref = max(float(np.asarray(js.lo).mean()), 1e-9)
    assert abs(float(ts.lo.mean()) - ref) / ref < 0.03
    assert _frac(jpdf, tpdf, 2e-3, 1e-5) >= 0.9995
    assert (np.asarray(jdelta) == tdelta.numpy()).mean() >= 0.9995
    assert (np.asarray(jvalid) == tvalid.numpy()).mean() >= 0.9995
    assert _frac(js.xs, ts.xs, 1e-3, 1e-4) >= 0.9995
    assert _frac(js.ns, ts.ns, 1e-3, 1e-4) >= 0.9995
    assert _frac(js.nv, ts.nv, 1e-4, 1e-5) == 1.0
    valid = tvalid.numpy()
    assert valid.mean() > 0.1 and float(ts.lo[tvalid].mean()) > 1e-3


def test_trace_routes_to_the_twin_on_the_cpu(world, pallas_trace):
    """On CPU tensors `trace_gi_sample_fused` is the twin's pack."""
    scene, tscene, cam = world
    cfg = _cfg(aa_jitter=False)
    _, (tit, tmat, td) = _primary(scene, cam, cfg, 5)
    got = tgi.trace_gi_sample_fused(tscene, tit, tmat, td, _tcfg(cfg), 5)
    _, _, want = pallas_trace
    for a, b in zip(want[0], got[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(want[1:], got[1:]))


def _close_frames(want, got, frac, rtol=1e-4, atol=1e-6):
    want = np.asarray(want).reshape(R, -1)
    got = got.numpy().reshape(R, -1)
    assert np.isfinite(got).all()
    ok = np.isclose(want, got, rtol=rtol, atol=atol).all(-1).mean()
    assert ok >= frac, ok


def test_restir_indirect_matches_jax(world):
    """The general GI reservoir route, three frames on the same primary
    hits and G-buffers (JAX's), the camera still."""
    scene, tscene, cam = world
    cfg = _cfg(aa_jitter=False)
    tcfg = _tcfg(cfg)
    res, tres = jrsv.zeros_indirect(R), trsv.zeros_indirect(R, "cpu")
    last, tlast = jgb.empty_gbuffer(R), tgb.empty_gbuffer(R, "cpu")
    for f in range(3):
        (gb, it, mat, d), (tit, tmat, td) = _primary(scene, cam, cfg, f)
        tgbuf = tgb.GBufferFrame(*(_t(x) for x in gb))
        ind, res = jgi.restir_indirect(scene, gb, last, it, mat, d, res, cfg,
                                       jnp.uint32(f))
        tind, tres = tgi.restir_indirect(tscene, tgbuf, tlast, tit, tmat, td,
                                         tres, tcfg, f)
        last, tlast = gb, tgbuf
        # measured: M equal everywhere, W within rtol 1e-5 on 0.9978-
        # 0.9993 of lanes (the trace's ulp-apart directions move Lo by
        # ~1e-6), within 2e-3 on >= 0.99976, indirect within 1e-3 on
        # >= 0.99927
        assert np.array_equal(np.asarray(res.m), tres.m.numpy())
        assert _frac(res.weight, tres.weight, 1e-5, 1e-7) >= 0.997
        assert _frac(res.weight, tres.weight, 2e-3, 1e-6) >= 0.9995
        _close_frames(ind, tind, 0.999, rtol=1e-3)
    assert int(tres.m.max()) == 3 and float(tind.mean()) > 1e-4


def test_renderer_step_matches_jax(world):
    """Three DI + GI frames of a general state (init_state without a
    scene), the camera moving on the last one."""
    scene, tscene, cam0 = world
    camkw = dict(position=(0.2, 2.75, 9.5), rotation=(-90.0, 0.0, 0.0),
                 fov_y=19.5, focal_dist=1.0)
    cams = [cam0, cam0, make_camera(**camkw)]
    cfg = _cfg(**mat_flags(scene))
    tcfg = _tcfg(cfg)
    jstate = jrenderer.init_state(cfg, cams[0])
    tstate = trenderer.init_state(tcfg, _tcam(cams[0]), device="cpu")
    assert isinstance(tstate.gi_reservoir, trsv.Reservoir)
    for cam in cams:
        jstate, jframe = jrenderer.step(scene, jstate, cam, cfg)
        tstate, tframe = trenderer.step(tscene, tstate, _tcam(cam), tcfg)
        assert tuple(tframe.shape) == (R, 3)
        _close_frames(jframe, tframe, 0.995)
    _close_frames(jstate.indirect_illum, tstate.indirect_illum, 0.995)
    assert float(tstate.indirect_illum.mean()) > 1e-4
    assert tstate.looper == 3 and int(tstate.gi_reservoir.m.max()) >= 2


@pytest.fixture
def on_tpu(monkeypatch):
    """JAX's fused gates also ask for a TPU: answer yes, as the port does
    for both devices (its kernels have CPU twins)."""
    monkeypatch.setattr(jix, "_on_tpu", lambda: True)


ROUTES = {
    # (config change, scene): fused state / general with the [Q_CH, R]
    # pack / general with a reservoir
    "fused": (dict(), "cornell"),
    "resolve_pack": (dict(ris_mode="reference"), "cornell"),
    "dof_pack": (dict(enable_dof=True), "cornell"),
    "env_reservoir": (dict(has_env_map=True), "env"),
    "ragged_reservoir": (dict(width=100), "cornell"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routing_matches_jax(on_tpu, route):
    change, which = ROUTES[route]
    if which == "env":
        scene, camkw = procedural.env_scene(bvh_impl="numpy")
    else:
        scene, camkw = procedural.cornell_box(bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    cam = make_camera(**camkw)
    cfg = _cfg(**{**mat_flags(scene), "aa_jitter": False, **change})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's fallback notice
        jstate = jrenderer.init_state(cfg, cam, scene)
    tstate = trenderer.init_state(_tcfg(cfg), _tcam(cam), tscene,
                                  device="cpu")
    fused = isinstance(jstate, jfused.FusedDIState)
    assert isinstance(tstate, tfused.FusedDIState) == fused
    assert fused == (route == "fused")
    if fused:
        assert tuple(tstate.gi_q.shape) == (tk.Q_CH, cfg.num_pixels)
        assert tuple(tstate.accum_ind.shape) == (3, cfg.num_pixels)
        return
    pack = isinstance(jstate.gi_reservoir, jnp.ndarray)
    assert isinstance(tstate.gi_reservoir, torch.Tensor) == pack
    assert pack == route.endswith("pack")


def test_fallback_notice(world):
    """The reason names the failed gate; it is given on the card only,
    so a CPU init_state stays silent."""
    _, tscene, cam = world
    cfg = tconfig.RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                               ris_mode="reference")
    reason = tfused.ineligibility_reason(cfg, tscene, "cuda")
    assert "ris_mode 'reference'" in reason
    assert tfused.ineligibility_reason(cfg, tscene, "cpu") is None
    big = cfg.replace(width=100, ris_mode="auto")
    reason = tfused.ineligibility_reason(big, tscene, "cuda")
    assert "gi_resolve_fused_eligible" in reason
    assert "3200 pixels not a multiple of 1024" in reason
    sobol = cfg.replace(ris_mode="auto", sampler="sobol")
    assert "sampler 'sobol'" in tfused.ineligibility_reason(sobol, tscene,
                                                            "cuda")
    pt = cfg.replace(tracer=TracerType.PT_DIRECT)
    assert tfused.ineligibility_reason(pt, tscene, "cuda") is None
    assert tfused.ineligibility(cfg.replace(ris_mode="auto"), tscene) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state = trenderer.init_state(cfg, _tcam(cam), tscene, device="cpu")
    assert isinstance(state.gi_reservoir, torch.Tensor)


def test_render_without_frames(world):
    """`render(..., num_frames=0)` returns a zero frame in the state's
    layout, as the JAX function does."""
    _, tscene, cam = world
    cfg = tconfig.RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI)
    state, frame = trenderer.render(tscene, _tcam(cam), cfg, 0,
                                    device="cpu")
    assert isinstance(state, tfused.FusedDIState)
    assert tuple(frame.shape) == (3, R) and float(frame.abs().sum()) == 0.0
    general = trenderer.init_state(cfg, _tcam(cam), device="cpu")
    state, frame = trenderer.render(tscene, _tcam(cam), cfg, 0, state=general)
    assert state is general
    assert tuple(frame.shape) == (R, 3) and float(frame.abs().sum()) == 0.0


@pytest.fixture(scope="module")
def jax_general(world, tmp_path_factory):
    """A JAX general RESTIR_GI state after two frames, its checkpoint and
    the JAX third frame from it."""
    scene, _, cam = world
    cfg = _cfg(**mat_flags(scene))
    state = jrenderer.init_state(cfg, cam)
    for _ in range(2):
        state, _ = jrenderer.step(scene, state, cam, cfg)
    path = str(tmp_path_factory.mktemp("gi") / "jax_general.npz")
    jrenderer.save_checkpoint(path, state)
    leaves = [np.array(x) for x in jax.tree.leaves(state)]
    _, frame = jrenderer.step(scene, state, cam, cfg)
    return cfg, path, leaves, np.asarray(frame)


def test_checkpoint_general_both_ways(world, jax_general, tmp_path):
    """A general GI state with a reservoir: JAX-written, read by the
    port, continued as JAX continues it, and written back for JAX."""
    _, tscene, cam = world
    cfg, path, leaves, jframe = jax_general
    tcfg = _tcfg(cfg)
    state = trenderer.load_checkpoint(path, tcfg, _tcam(cam), device="cpu")
    assert isinstance(state.gi_reservoir, trsv.Reservoir)
    got = convert.render_state_to_numpy(state)
    assert len(got) == len(leaves)
    for want, g in zip(leaves, got):
        assert want.dtype == g.dtype and np.array_equal(want, g)
    out = str(tmp_path / "port_general.npz")
    trenderer.save_checkpoint(out, state)
    back = jrenderer.load_checkpoint(out, cfg, cam)
    for want, g in zip(leaves, jax.tree.leaves(back)):
        assert np.array_equal(want, np.asarray(g))
    _, frame = trenderer.step(tscene, state, _tcam(cam), tcfg)
    _close_frames(jframe, frame, 0.995)


def test_checkpoint_resolve_pack_both_ways(world, on_tpu, tmp_path):
    """A general state whose GI reservoir is the resolve pack: written by
    JAX (routed as on the TPU) and read by the port, and back."""
    scene, tscene, cam = world
    cfg = _cfg(ris_mode="reference", **mat_flags(scene))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's fallback notice
        jstate = jrenderer.init_state(cfg, cam, scene)
    assert isinstance(jstate.gi_reservoir, jnp.ndarray)
    q = np.random.default_rng(11).normal(size=(tk.Q_CH, R)).astype(
        np.float32)
    jstate = jstate._replace(gi_reservoir=jnp.asarray(q),
                             looper=jnp.uint32(7))
    path = str(tmp_path / "jax_pack.npz")
    jrenderer.save_checkpoint(path, jstate)
    state = trenderer.load_checkpoint(path, _tcfg(cfg), _tcam(cam), tscene,
                                      device="cpu")
    assert isinstance(state, trenderer.RenderState) and state.looper == 7
    assert np.array_equal(state.gi_reservoir.numpy(), q)
    out = str(tmp_path / "port_pack.npz")
    trenderer.save_checkpoint(out, state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = jrenderer.load_checkpoint(out, cfg, cam, scene)
    for want, got in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(want), np.asarray(got))
    reset = trenderer.reset_accumulation(state)
    assert float(reset.gi_reservoir.abs().sum()) == 0.0
