"""The port's fused ReSTIR GI stage against the JAX package's, on the CPU.

cornell_box() at 128x32 (the `lambert` and `metal_glass` blocks of
tests/test_gi_fused.py):

- B9's twin `gi_resolve_ref` against `gi_kernel.gi_resolve_pallas(...,
  interpret=True)` over three frames on the same trace packs (the Pallas
  trace's), and the port's `restir_indirect_fused` against JAX's on the
  same trace packs: test_gi_resolve_matches_xla's gates (M equal, W
  within rtol 1e-5, indirect within rtol 1e-3), here on every lane;
- the port's fused RESTIR_GI `step_fused` (twins of B1, B2, B8, B9)
  against `restir_di_fused.step_fused(..., interpret=True)` over three
  frames, the camera moving on the last: `accum_ind`, `gi_q` and the
  frame, at the fractions measured here;
- `reset_accumulation`, fused GI checkpoints both ways and the CUDA
  wrappers' argument checks.
"""

import dataclasses

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
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import gi_kernel as jk
from restir_tpu.scene import procedural
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import gbuffer as tgb
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.models import restir_gi as tgi
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


def _cfg(scene, **kw):
    return RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_GI,
                        **{**mat_flags(scene), **kw})


def _frac(want, got, rtol, atol):
    """Share of lanes of [C, R] (or [R]) arrays whose every channel
    agrees."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ok = np.isclose(np.asarray(want), got, rtol=rtol, atol=atol)
    return float((ok.all(0) if ok.ndim > 1 else ok).mean())


@pytest.fixture(scope="module", params=["lambert", "metal_glass"])
def world(request):
    kw = {}
    if request.param == "metal_glass":
        kw["block_materials"] = ("metal", "glass")
    scene, camkw = procedural.cornell_box(bvh_impl="numpy", **kw)
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    cam1 = make_camera(**{**camkw, "position": (0.15, 2.75, 9.5)})
    return scene, tscene, [make_camera(**camkw)] * 2 + [cam1]


def test_layout_constants_match():
    names = [n for n in dir(jk) if n.split("_")[0] in (
        "IN", "GO", "Q", "GQ")]
    assert len(names) > 30
    for name in names:
        assert getattr(tk, name) == getattr(jk, name), name
    assert tk.CTR_UPDATE == jk._CTR_UPDATE
    assert tk.CTR_TEMPORAL == jk._CTR_TEMPORAL
    assert tk.CTR_PATH == jk._CTR_PATH
    assert tk.SALT_GI == jk._SALT_GI


@pytest.fixture(scope="module")
def resolve_frames(world):
    """Three frames of the JAX resolve on the Pallas trace's packs, and
    the port's inputs for the same frames."""
    scene, tscene, cams = world
    cfg = _cfg(scene, aa_jitter=False)
    frames = []
    q = jgi.init_gi_resolve_pack(R)
    for f in range(3):
        gb, it, mat, d = jgb.render_gbuffer(scene, cams[f], cams[f], cfg,
                                            jnp.uint32(f))
        in_pack = jgi._build_gi_in_pack(it, mat, d)
        go = jk.gi_trace_pallas(
            in_pack, jnp.uint32(f), scene.tri_xform, scene.prim_attr,
            scene.mat_attr, scene.light_prob, scene.light_alias,
            scene.light_prim_ids, scene.light_radiance,
            scene.sum_light_power_inv, depth=cfg.trace_depth,
            single_sided=True, n_lights=int(scene.light_prob.shape[0]),
            has_met=cfg.scene_has_metallic,
            has_die=cfg.scene_has_dielectric,
            has_proc=cfg.scene_has_procedural, interpret=True)
        want_ind, want_q = jgi.restir_indirect_fused(
            scene, gb, it, mat, d, q, cfg, jnp.uint32(f), interpret=True)
        frames.append(dict(
            gb=gb, it=it, mat=mat, d=d, go=np.asarray(go).reshape(16, R),
            in_pack=np.asarray(in_pack).reshape(16, R), q_prev=np.asarray(q),
            ind=np.asarray(want_ind), q=np.asarray(want_q)))
        q = want_q
    return cfg, frames


def _resolve_gates(want_ind, want_q, ind, q):
    """test_gi_resolve_matches_xla's gates, on every lane."""
    assert np.array_equal(want_q[jk.Q_M], q[tk.Q_M].numpy())
    assert _frac(want_q[jk.Q_W], q[tk.Q_W], 1e-5, 1e-7) == 1.0
    assert _frac(want_ind, ind, 1e-3, 1e-6) == 1.0
    assert _frac(want_q[jk.Q_LO:jk.Q_LO + 3], q[tk.Q_LO:tk.Q_LO + 3], 1e-5,
                 1e-7) == 1.0
    assert float(q[jk.Q_DEPTH + 1:].abs().max()) == 0.0


def test_resolve_twin_matches_pallas(world, resolve_frames):
    _, tscene, _ = world
    cfg, frames = resolve_frames
    q = torch.zeros((tk.Q_CH, R))
    for f, fr in enumerate(frames):
        gb = fr["gb"]
        shade = fr["it"].valid & (gb.prim_id != tgb.LIGHT_ID)
        gq = torch.stack([_t(x) for x in (
            gb.motion.astype(jnp.float32), gb.prim_id.astype(jnp.float32),
            gb.depth, gb.norm[:, 0], gb.norm[:, 1], gb.norm[:, 2],
            gb.albedo[:, 0], gb.albedo[:, 1], gb.albedo[:, 2],
            shade.astype(jnp.float32))])
        ind, q = tk.gi_resolve(_t(fr["go"]), _t(fr["in_pack"]), gq, q, f,
                               temporal_clamp=cfg.temporal_clamp,
                               has_met=cfg.scene_has_metallic)
        _resolve_gates(fr["ind"].T, fr["q"], ind, q)
    assert float(q[tk.Q_M].max()) == 3.0 and float(ind.mean()) > 1e-4


def test_restir_indirect_fused_matches_jax(world, resolve_frames,
                                           monkeypatch):
    """The port's fused GI frame on the same trace packs: its IN and GQ
    packs and B9's twin against JAX's."""
    _, tscene, _ = world
    cfg, frames = resolve_frames
    tcfg = _tcfg(cfg)
    q = tgi.init_gi_resolve_pack(R, "cpu")
    for f, fr in enumerate(frames):
        monkeypatch.setattr(tk, "gi_trace",
                            lambda *a, _go=fr["go"], **k: _t(_go))
        it, mat = fr["it"], fr["mat"]
        tit = Interaction(valid=_t(it.valid), prim_id=_t(it.prim_id),
                          mat_id=_t(it.mat_id), pos=_t(it.pos),
                          norm=_t(it.norm), uv=_t(it.uv))
        tmat = SurfaceMaterial(type=_t(mat.type),
                               base_color=_t(mat.base_color),
                               metallic=_t(mat.metallic),
                               roughness=_t(mat.roughness), ior=_t(mat.ior))
        assert np.array_equal(
            tgi._build_gi_in_pack(tit, tmat, _t(fr["d"])).numpy(),
            fr["in_pack"])
        ind, q = tgi.restir_indirect(
            tscene, tgb.GBufferFrame(*(_t(x) for x in fr["gb"])), None, tit,
            tmat, _t(fr["d"]), q, tcfg, f)
        assert tuple(ind.shape) == (R, 3)
        _resolve_gates(fr["ind"].T, fr["q"], ind.T, q)


@pytest.fixture(scope="module")
def fused_run(world):
    """Three fused RESTIR_GI frames: JAX (interpret mode) and the port
    (twins), from the same initial state."""
    scene, tscene, cams = world
    cfg = _cfg(scene)
    jstate = jfused.init_state(cfg, cams[0])
    tstate = tfused.init_state(_tcfg(cfg), _tcam(cams[0]), "cpu")
    out = []
    for cam in cams:
        jstate, jframe = jfused.step_fused(scene, jstate, cam, cfg,
                                           interpret=True)
        jleaves = [np.array(x) for x in jax.tree.leaves(jstate)]
        tstate, tframe = tfused.step_fused(tscene, tstate, _tcam(cam),
                                           _tcfg(cfg))
        out.append((jleaves, np.asarray(jframe).reshape(3, R), tstate,
                    tframe.clone()))
    return cfg, out


def test_step_fused_matches_jax(world, fused_run):
    """accum_ind, the resolve pack and the frame, every frame. Measured:
    M equal everywhere; W within rtol 2e-3, accum_ind and the frame
    within 1e-3 on >= 0.99951 of lanes (the Pallas trace and B8's twin
    round the light point and the hit tests apart, see test_torch_gi.py:
    a lane rerouted moves its pixel), W within 1e-5 on >= 0.9897."""
    cfg, out = fused_run
    for jleaves, jframe, tstate, tframe in out:
        jq = jleaves[6].reshape(jk.Q_CH, R)
        assert tuple(tstate.gi_q.shape) == (tk.Q_CH, R)
        assert np.array_equal(jq[jk.Q_M], tstate.gi_q[tk.Q_M].numpy())
        assert _frac(jq[jk.Q_W], tstate.gi_q[tk.Q_W], 2e-3, 1e-6) >= 0.9995
        assert _frac(jq[jk.Q_W], tstate.gi_q[tk.Q_W], 1e-5, 1e-7) >= 0.985
        assert _frac(jleaves[5].reshape(3, R), tstate.accum_ind, 1e-3,
                     1e-6) >= 0.9995
        assert _frac(jframe, tframe, 1e-3, 1e-6) >= 0.9995
        assert bool(torch.isfinite(tframe).all())
    assert float(tstate.accum_ind.mean()) > 1e-4
    assert float(tstate.gi_q[tk.Q_M].max()) == 3.0
    # the frame is the direct mean plus the indirect mean
    assert torch.equal(tframe, tstate.accum + tstate.accum_ind)


def test_reset_zeroes_gi_history(fused_run):
    _, out = fused_run
    state = out[-1][2]
    assert float(state.gi_q.abs().sum()) > 0.0
    reset = tfused.reset_accumulation(state)
    assert reset.iteration == 0 and reset.looper == state.looper
    for name in ("accum", "pt_pack", "accum_ind", "gi_q"):
        t = getattr(reset, name)
        assert t.shape == getattr(state, name).shape, name
        assert float(t.abs().sum()) == 0.0, name
    assert trenderer.reset_accumulation(state).gi_q.abs().sum() == 0.0


def test_fused_checkpoint_both_ways(world, fused_run, tmp_path,
                                   monkeypatch):
    """A JAX-written fused GI checkpoint loads into the port, continues as
    JAX does, and the port writes the JAX layout back."""
    scene, tscene, cams = world
    cfg, out = fused_run
    jleaves = out[1][0]
    jstate = jax.tree.unflatten(
        jax.tree.structure(jfused.init_state(cfg, cams[0])),
        [jnp.asarray(x) for x in jleaves])
    path = str(tmp_path / "jax_fused_gi.npz")
    jrenderer.save_checkpoint(path, jstate)
    state = trenderer.load_checkpoint(path, _tcfg(cfg), _tcam(cams[0]),
                                      tscene, device="cpu")
    assert isinstance(state, tfused.FusedDIState) and state.looper == 2
    got = convert.state_to_numpy(state)
    for want, g in zip(jleaves, got):
        assert np.shape(want) == np.shape(g) and np.array_equal(want, g)
    _, frame = trenderer.step(tscene, state, _tcam(cams[2]), _tcfg(cfg))
    assert _frac(out[2][1], frame, 1e-3, 1e-6) >= 0.998
    back = str(tmp_path / "port_fused_gi.npz")
    trenderer.save_checkpoint(back, out[2][2])
    # JAX routes to its fused state only on a TPU: answer yes
    from restir_tpu.ops import intersect as jix

    monkeypatch.setattr(jix, "_on_tpu", lambda: True)
    reread = jrenderer.load_checkpoint(back, cfg, cams[0], scene)
    assert isinstance(reread, jfused.FusedDIState)
    for want, g in zip(convert.state_to_numpy(out[2][2]),
                       jax.tree.leaves(reread)):
        assert np.array_equal(want, np.asarray(g))


def test_cuda_wrappers_check_arguments(world):
    """The CUDA entry points refuse bad shapes before they need a
    compiler or a card."""
    _, tscene, _ = world
    kw = dict(depth=5, single_sided=True,
              n_lights=int(tscene.light_prob.shape[0]))
    with pytest.raises(ValueError, match="expected float32"):
        tk.gi_trace_cuda(torch.zeros((tk.IN_CH - 1, 64)), 0, tscene, **kw)
    with pytest.raises(ValueError, match="n_lights"):
        tk.gi_trace_cuda(torch.zeros((tk.IN_CH, 64)), 0, tscene,
                         **{**kw, "n_lights": 3})
    with pytest.raises(ValueError, match="depth"):
        tk.gi_trace_cuda(torch.zeros((tk.IN_CH, 64)), 0, tscene,
                         **{**kw, "depth": 0})
    z = torch.zeros
    with pytest.raises(ValueError, match="whole 1024-pixel tiles"):
        tk.gi_resolve_cuda(z((tk.GO_CH, 1000)), z((tk.IN_CH, 1000)),
                           z((tk.GQ_CH, 1000)), z((tk.Q_CH, 1000)), 0)
    with pytest.raises(ValueError, match="q_prev"):
        tk.gi_resolve_cuda(z((tk.GO_CH, 1024)), z((tk.IN_CH, 1024)),
                           z((tk.GQ_CH, 1024)), z((tk.Q_CH - 1, 1024)), 0)
