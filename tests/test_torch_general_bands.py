"""The general frame in row bands (`restir_tpu_torch.parallel.shard_state`
/ `make_sharded_step`) on the CPU.

- Against JAX: the port's banded step on ["cpu"] x 2 against the JAX
  package's `make_sharded_step` on 2 virtual devices, cornell_box() at
  16x32, 3 frames from the same zero state with the camera moving on the
  last, for ReSTIR DI + SVGF and ReSTIR GI (trace_depth 3): radiance
  within rtol 1e-4 / atol 1e-6 on >= 99.5 % of pixels (the gate of
  tests/test_torch_general.py).
- Band counts: at 64x32, 3 frames of 1, 2, 4 and 8 bands (8 bands of 4
  rows: the spatial taps and the denoisers' halos cross several bands)
  equal each other bit for bit for every tracer, both reservoir forms of
  ReSTIR GI (the [Q_CH, R] resolve pack in 1 and 2 bands of 1024
  pixels), both RIS modes, the Sobol sampler, DoF, EAW and SVGF, and
  `renderer.step_general`'s frames within rtol 1e-5 / atol 1e-6 (the
  JAX sharding test's tolerance); the last frame's motion reaches across
  band edges.
- The band arguments of B10's and B9's twins: a band's outputs equal the
  whole-frame twin's at its pixels bit for bit.
- The state's round trip (`shard_state` -> `gather_state` ->
  `save_checkpoint`, read back by the JAX package) and the refusals.
Torch runs on one intra-op thread here, as in tests/test_torch_sharding.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.ops.camera import make_camera
from restir_tpu.parallel import make_mesh as j_mesh
from restir_tpu.parallel import make_sharded_step as j_step
from restir_tpu.parallel import shard_scene as j_shard_scene
from restir_tpu.parallel import shard_state as j_shard
from restir_tpu.scene.procedural import cornell_box
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert, parallel
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import gbuffer as tgb
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.models import restir_gi as tgi
from restir_tpu_torch.ops.kernels import gi as gk
from restir_tpu_torch.ops.kernels import ris_cdf
from restir_tpu_torch.parallel import sharding

TC = tconfig.TracerType
W, H = 64, 32  # band counts: bands of 32, 16, 8 and 4 rows
BANDS = (1, 2, 4, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its many small torch ops
    otherwise spend most of their time in the thread pool when several
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    scene, camkw = cornell_box(bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    pos = camkw["position"]
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (pos[0] + 0.3, pos[1] + 0.4,
                                                pos[2])})
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


def _banded(tscene, state, cams, cfg, n):
    """The port's banded step on ["cpu"] x n from `state` -> (gathered
    state, gathered [R, 3] frames)."""
    mesh = parallel.make_mesh(["cpu"] * n)
    step = parallel.make_sharded_step(cfg, mesh, state)
    scenes = parallel.shard_scene(tscene, mesh)
    state = parallel.shard_state(state, mesh, cfg)
    frames = []
    for cam in cams:
        state, frame = step(scenes, state, cam)
        assert len(frame) == n and frame[0].shape == (cfg.num_pixels // n, 3)
        frames.append(parallel.gather(frame, "cpu", dim=0))
    return parallel.gather_state(state, "cpu"), frames


JAX_CASES = {
    "restir_di_svgf": dict(tracer=TracerType.RESTIR_DI,
                           denoiser=DenoiserType.SVGF),
    "restir_gi": dict(tracer=TracerType.RESTIR_GI, trace_depth=3),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_banded_step_matches_jax_sharded_step(world, case):
    scene, tscene, cams = world
    cfg = RenderConfig(width=16, height=32, **mat_flags(scene),
                       **JAX_CASES[case])
    mesh = j_mesh(jax.devices()[:2])
    state = j_shard(jrenderer.init_state(cfg, cams[0]), mesh, cfg)
    step = j_step(cfg, mesh, state)
    scene_r = j_shard_scene(scene, mesh)
    jframes = []
    for cam in cams:
        state, frame = step(scene_r, state, cam)
        jframes.append(np.asarray(frame))
    tcfg = _tcfg(cfg)
    tcams = [_tcam(c) for c in cams]
    tstate, tframes = _banded(
        tscene, trenderer.init_state(tcfg, tcams[0], device="cpu"), tcams,
        tcfg, 2)
    assert tstate.looper == 3 and tstate.iteration == 3
    for want, got in zip(jframes, tframes):
        _close_px(want, got)
    assert float(tframes[-1].mean()) > 0.0


BAND_CASES = {
    "pt_direct": dict(tracer=TC.PT_DIRECT),
    "pt_full": dict(tracer=TC.PT_FULL, trace_depth=3),
    "pt_indirect": dict(tracer=TC.PT_INDIRECT, trace_depth=3),
    "restir_di_cdf_eaw": dict(tracer=TC.RESTIR_DI,
                              denoiser=tconfig.DenoiserType.EAW),
    "restir_di_reference_svgf": dict(tracer=TC.RESTIR_DI,
                                     ris_mode="reference",
                                     denoiser=tconfig.DenoiserType.SVGF),
    "restir_gi": dict(tracer=TC.RESTIR_GI, trace_depth=3),
    "restir_gi_resolve_pack_eaw": dict(tracer=TC.RESTIR_GI, trace_depth=3,
                                       denoiser=tconfig.DenoiserType.EAW),
    "bvh_visualize": dict(tracer=TC.BVH_VISUALIZE),
    "gbuffer_preview_depth": dict(tracer=TC.GBUFFER_PREVIEW,
                                  gbuffer_channel="depth"),
    "gbuffer_preview_position": dict(tracer=TC.GBUFFER_PREVIEW,
                                     gbuffer_channel="position"),
    "sobol_dof_svgf": dict(tracer=TC.PT_DIRECT, sampler="sobol",
                           enable_dof=True,
                           denoiser=tconfig.DenoiserType.SVGF),
}


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_counts_give_identical_frames(world, case):
    scene, tscene, cams = world
    cfg = tconfig.RenderConfig(width=W, height=H, **mat_flags(scene),
                               **BAND_CASES[case])
    tcams = [_tcam(c) for c in cams]
    pack = case == "restir_gi_resolve_pack_eaw"

    def init():
        return trenderer.init_general(cfg, tcams[0], "cpu",
                                      tscene if pack else None)

    assert isinstance(init().gi_reservoir, torch.Tensor) == pack
    runs = {n: _banded(tscene, init(), tcams, cfg, n)[1]
            for n in ((1, 2) if pack else BANDS)}
    state = init()
    for i, cam in enumerate(tcams):
        state, single = trenderer.step_general(tscene, state, cam, cfg)
        assert torch.isfinite(runs[1][i]).all()
        assert float(runs[1][i].mean()) > 0.0
        for n, frames in runs.items():
            assert torch.equal(frames[i], runs[1][i]), (n, i)
        torch.testing.assert_close(runs[1][i], single, rtol=1e-5, atol=1e-6)


def test_moving_camera_reaches_across_bands(world):
    """The last frame's temporal taps cross band edges: the motion of over
    a tenth of the valid lanes points into another band of 8 (4 rows),
    up to 3 rows away."""
    scene, tscene, cams = world
    cfg = tconfig.RenderConfig(width=W, height=H)
    gb = tgb.render_gbuffer(tscene, _tcam(cams[2]), _tcam(cams[1]), cfg,
                            2)[0]
    r_loc = W * H // 8
    pix = torch.arange(W * H)
    valid = (gb.motion >= 0) & (gb.prim_id > tgb.NULL_PRIMITIVE)
    other = valid & (gb.motion // r_loc != pix // r_loc)
    assert float(other.float().sum()) > 0.1 * float(valid.float().sum())
    rows = torch.abs(gb.motion // W - pix // W)[valid]
    assert int(rows.max()) >= 3
    ranges = sharding.motion_ranges(
        [gb._replace(**{f: getattr(gb, f)[b * r_loc:(b + 1) * r_loc]
                        for f in gb._fields}) for b in range(8)], W * H,
        "cpu")
    assert any(lo < b * r_loc or hi > (b + 1) * r_loc
               for b, (lo, hi) in enumerate(ranges))


def _general_inputs(tscene, cams, cfg, looper):
    gb, it, mat, d = tgb.render_gbuffer(tscene, _tcam(cams[2]),
                                        _tcam(cams[1]), cfg, looper)
    return gb, it, mat, d


def test_b10_twin_band_equals_whole_frame(world):
    _, tscene, cams = world
    cfg = tconfig.RenderConfig(width=W, height=H, tracer=TC.RESTIR_DI)
    gb, it, mat, d = _general_inputs(tscene, cams, cfg, 5)
    wo = -d
    norm = torch.where(((mat.type != 2) & ((it.norm * wo).sum(-1) < 0))[
        ..., None], -it.norm, it.norm)
    pack = ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness,
                               it.valid & (gb.prim_id != tgb.LIGHT_ID),
                               it.prim_id)
    whole = ris_cdf.ris_cdf_ref(pack, 5, tscene.tables)
    assert float(whole[ris_cdf.OUT_W].max()) > 0.0
    r_loc = W * H // 4
    for b in range(4):
        sl = slice(b * r_loc, (b + 1) * r_loc)
        band = ris_cdf.ris_cdf_ref(pack[:, sl].contiguous(), 5,
                                   tscene.tables, pix0=b * r_loc)
        assert torch.equal(band, whole[:, sl]), b
    # the draws follow the global pixel: a band keyed from 0 differs
    off = ris_cdf.ris_cdf_ref(pack[:, r_loc:2 * r_loc].contiguous(), 5,
                              tscene.tables)
    assert not torch.equal(off, whole[:, r_loc:2 * r_loc])


def test_b9_twin_band_equals_whole_frame(world):
    """Frame 2 of B9's twin after a moving camera, on 2 bands of 1024
    pixels: each band with the range of the previous pack its motion
    reaches equals the whole-frame twin at its pixels."""
    _, tscene, cams = world
    cfg = tconfig.RenderConfig(width=W, height=H, tracer=TC.RESTIR_GI,
                               trace_depth=2)
    r = W * H
    q = torch.zeros((gk.Q_CH, r))
    for looper, (cam, last) in enumerate(((cams[0], cams[0]),
                                          (cams[2], cams[0]))):
        gb, it, mat, d = tgb.render_gbuffer(tscene, _tcam(cam), _tcam(last),
                                            cfg, looper)
        in_pack = tgi._build_gi_in_pack(it, mat, d)
        go = gk.gi_trace_ref(in_pack, looper, tscene,
                             **tgi.trace_kwargs(tscene, cfg))
        gq = tgi._gq_pack(gb, it)
        prev = q
        ind, q = gk.gi_resolve_ref(go, in_pack, gq, q, looper)
    assert float(q[gk.Q_M].max()) == 2.0
    r_loc = r // 2
    for b in range(2):
        sl = slice(b * r_loc, (b + 1) * r_loc)
        (lo, hi), = sharding.motion_ranges(
            [gb._replace(**{f: getattr(gb, f)[sl] for f in gb._fields})],
            r, "cpu")
        assert (lo, hi) != (b * r_loc, (b + 1) * r_loc)
        ind_b, q_b = gk.gi_resolve_ref(
            go[:, sl], in_pack[:, sl], gq[:, sl], prev[:, lo:hi].contiguous(),
            1, pix0=b * r_loc, prev_base=lo, r_prev=r)
        assert torch.equal(ind_b, ind[:, sl]), b
        assert torch.equal(q_b, q[:, sl]), b


def test_state_round_trip(world, tmp_path):
    """A banded DI + SVGF state after two frames gathers to the state
    one device renders, and its checkpoint loads in the JAX package."""
    scene, tscene, cams = world
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.SVGF, **mat_flags(scene))
    tcfg = _tcfg(cfg)
    tcams = [_tcam(c) for c in cams[:2]]
    state = trenderer.init_state(tcfg, tcams[0], device="cpu")
    mesh = parallel.make_mesh(["cpu"] * 4)
    banded = parallel.shard_state(state, mesh, tcfg)
    assert isinstance(banded.dir_reservoir.weight, list)
    assert banded.gbuffer.motion[3].shape == (W * H // 4,)
    back = parallel.gather_state(banded, "cpu")
    for a, b in zip(convert.render_state_to_numpy(state),
                    convert.render_state_to_numpy(back)):
        assert np.array_equal(a, b)
    gathered, _ = _banded(tscene, state, tcams, tcfg, 4)
    single = state
    for cam in tcams:
        single, _ = trenderer.step_general(tscene, single, cam, tcfg)
    path = str(tmp_path / "banded.npz")
    trenderer.save_checkpoint(path, gathered)
    jstate = jrenderer.load_checkpoint(path, cfg, cams[0])
    for want, got in zip(convert.render_state_to_numpy(gathered),
                         jax.tree.leaves(jstate)):
        assert np.array_equal(want, np.asarray(got))
    for a, b in zip(convert.render_state_to_numpy(gathered),
                    convert.render_state_to_numpy(single)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ("height", "resolve_tiles", "fused"))
def test_refusals(world, case):
    _, tscene, cams = world
    cam = _tcam(cams[0])
    if case == "height":
        cfg = tconfig.RenderConfig(width=W, height=H, tracer=TC.PT_DIRECT)
        state = trenderer.init_general(cfg, cam, "cpu")
        mesh = parallel.make_mesh(["cpu"] * 3)
        with pytest.raises(ValueError, match="H % n"):
            parallel.make_sharded_step(cfg, mesh, state)
        with pytest.raises(ValueError, match="H % n"):
            parallel.shard_state(state, mesh, cfg)
    elif case == "resolve_tiles":
        cfg = tconfig.RenderConfig(width=W, height=H, tracer=TC.RESTIR_GI,
                                   trace_depth=3)
        state = trenderer.init_general(cfg, cam, "cpu", tscene)
        assert isinstance(state.gi_reservoir, torch.Tensor)
        mesh = parallel.make_mesh(["cpu"] * 4)  # bands of 512 pixels
        with pytest.raises(ValueError, match="1024-pixel tiles"):
            parallel.make_sharded_step(cfg, mesh, state)
        with pytest.raises(ValueError, match="1024-pixel tiles"):
            parallel.shard_state(state, mesh, cfg)
    else:
        cfg = tconfig.RenderConfig(width=128, height=16)
        state = tfused.init_state(cfg, cam, "cpu")
        mesh = parallel.make_mesh(["cpu"] * 2)
        with pytest.raises(TypeError, match="make_fused_sharded_step"):
            parallel.make_sharded_step(cfg, mesh, state)
        with pytest.raises(TypeError, match="make_fused_sharded_step"):
            parallel.shard_state(state, mesh, cfg)
