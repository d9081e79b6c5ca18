"""The fused DI frame over row bands (`restir_tpu_torch.parallel`) on the
CPU, against the JAX package's `make_fused_sharded_step`.

- The slice: the port's banded step on ["cpu"] x 2 against JAX's
  `make_fused_sharded_step(interpret=True)` on 2 virtual devices, for
  many_light_scene(16, 6) at 128x16, 2 frames from the same converted
  state, with EAW and with SVGF (the image gates of
  tests/test_torch_slice.py); the gathered state writes the JAX leaf
  layout and its checkpoint loads back.
- Bands against one band: at 128x32 the frames of 1, 2 and 4 bands (4
  bands of 8 rows: the denoiser's halo crosses several bands) equal each
  other bit for bit, and the single-device `step_fused`'s within rtol
  1e-5 / atol 1e-6 (the JAX test's tolerance, tests/test_sharding.py).
- Refusals, the state's round trip through `shard_fused_state` and
  `gather`, and the mesh's default.
The card's test of the same step is in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops.camera import make_camera
from restir_tpu.parallel import make_fused_sharded_step as j_step
from restir_tpu.parallel import make_mesh as j_mesh
from restir_tpu.parallel import shard_fused_state as j_shard
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert, parity
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.ops.kernels import fused_di as tk
from restir_tpu_torch.parallel import (
    gather,
    make_fused_sharded_step,
    make_mesh,
    shard_fused_state,
    shard_scene,
)
from restir_tpu_torch.scene.procedural import many_light_scene as t_scene

W, H = 128, 16  # the slice against JAX: R = 2048, two bands of 1024
FRAMES = 2
DENOISERS = ("EAW", "SVGF")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its thousands of small torch
    ops otherwise spend most of their time in the thread pool when
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=6,
                                    bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, make_camera(**camkw), mat_flags(scene)


def _cfg(flags, den, w=W, h=H):
    return RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                        denoiser=getattr(DenoiserType, den), ris_mode="cdf",
                        **flags)


def _port(cfg):
    return tconfig.RenderConfig(**dataclasses.asdict(cfg))


def _port_cam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


def _leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _image_gates(want, got):
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
    frac = np.isclose(want, got, rtol=1e-3, atol=1e-6).mean()
    return mean_rel, frac


def _port_run(tscene, state, cam, cfg, n, frames):
    """The port's banded step on ["cpu"] x n: (gathered state, gathered
    frames)."""
    mesh = make_mesh(["cpu"] * n)
    step = make_fused_sharded_step(cfg, mesh)
    scenes = shard_scene(tscene, mesh)
    state = shard_fused_state(state, mesh)
    out = []
    for _ in range(frames):
        state, frame = step(scenes, state, cam)
        out.append(gather(frame, "cpu").numpy().copy())
    return gather(state, "cpu"), out


@pytest.mark.parametrize("den", DENOISERS)
def test_banded_step_matches_jax_sharded_step(world, tmp_path, den):
    scene, tscene, cam, flags = world
    cfg = _cfg(flags, den)
    mesh = j_mesh(jax.devices()[:2])
    state = jfused.init_state(cfg, cam)
    leaves0 = _leaves(state)
    state = j_shard(state, mesh)
    step = j_step(cfg, mesh, interpret=True)
    jframes = []
    for _ in range(FRAMES):
        state, frame = step(scene, state, cam)
        jframes.append(np.asarray(frame).reshape(3, W * H))
    jleaves = _leaves(state)

    tcfg = _port(cfg)
    tstate, tframes = _port_run(
        tscene, convert.state_from_numpy(leaves0, tcfg, "cpu"),
        _port_cam(cam), tcfg, 2, FRAMES)
    for i, (want, got) in enumerate(zip(jframes, tframes)):
        assert got.shape == (3, W * H) and np.isfinite(got).all()
        mean_rel, frac = _image_gates(want, got)
        assert mean_rel < 0.01, (i, mean_rel)
        assert frac >= 0.99, (i, frac)
    # the gathered state is the JAX state's layout, its picks the JAX
    # state's, and its checkpoint loads back
    assert tstate.looper == int(jleaves[0])
    assert tstate.iteration == int(jleaves[1])
    pt_j = jleaves[3].reshape(tk.PT_CH, W * H)
    same = np.all(pt_j[0:3] == tstate.pt_pack[0:3].numpy(), axis=0)
    assert same.mean() >= parity.PICK_MATCH_MIN
    leaves = convert.state_to_numpy(tstate)
    assert [np.shape(x) for x in leaves] == [x.shape for x in jleaves]
    path = str(tmp_path / "banded.npz")
    trenderer.save_checkpoint(path, tstate)
    back = trenderer.load_checkpoint(path, tcfg, _port_cam(cam), tscene,
                                     device="cpu")
    assert torch.equal(back.accum, tstate.accum)
    assert torch.equal(back.pt_pack, tstate.pt_pack)
    assert torch.equal(back.svgf_pack, tstate.svgf_pack)


@pytest.mark.parametrize("den", DENOISERS)
def test_band_counts_give_identical_frames(world, den):
    _, tscene, cam, flags = world
    tcfg = _port(_cfg(flags, den, 128, 32))
    tcam = _port_cam(cam)
    runs = {n: _port_run(tscene, tfused.init_state(tcfg, tcam, "cpu"), tcam,
                         tcfg, n, 3)[1]
            for n in (1, 2, 4)}
    state = tfused.init_state(tcfg, tcam, "cpu")
    for i in range(3):
        state, frame = tfused.step_fused(tscene, state, tcam, tcfg)
        single = frame.numpy()
        assert np.isfinite(runs[1][i]).all() and runs[1][i].mean() > 0.0
        for n in (2, 4):
            assert np.array_equal(runs[n][i], runs[1][i]), (n, i)
        np.testing.assert_allclose(runs[1][i], single, rtol=1e-5, atol=1e-6)


def _refuse(world, **kw):
    _, tscene, cam, flags = world
    cfg = _port(_cfg(flags, "EAW")).replace(**kw)
    return cfg, tscene, _port_cam(cam)


@pytest.mark.parametrize("case", ("gi", "ineligible", "unaligned",
                                  "large_scene"))
def test_refusals(world, case):
    mesh = make_mesh(["cpu"] * 2)
    if case == "gi":
        cfg, _, _ = _refuse(world, tracer=tconfig.TracerType.RESTIR_GI)
        with pytest.raises(NotImplementedError, match="RESTIR_GI"):
            make_fused_sharded_step(cfg, mesh)
    elif case == "ineligible":
        cfg, _, _ = _refuse(world, sampler="sobol")
        with pytest.raises(NotImplementedError, match="sampler"):
            make_fused_sharded_step(cfg, mesh)
    elif case == "unaligned":
        cfg, _, _ = _refuse(world, height=8)  # R = 1024: one tile
        with pytest.raises(ValueError, match="1024-pixel aligned"):
            make_fused_sharded_step(cfg, mesh)
    else:
        arrays, camkw = t_scene(16, 120)
        big = convert.scene_from_numpy(arrays, "cpu")
        assert big.num_tris > tfused.RESIDENT_MAX_TRIS
        cfg = tconfig.RenderConfig(width=W, height=H,
                                   **tconfig.mat_flags(arrays))
        cam = convert.camera_from_numpy(
            [np.asarray(x) for x in make_camera(**camkw)])
        step = make_fused_sharded_step(cfg, mesh)
        state = shard_fused_state(tfused.init_state(cfg, cam, "cpu"), mesh)
        with pytest.raises(ValueError,
                           match=r"resident path.*\(ROADMAP A9c\)"):
            step(shard_scene(big, mesh), state, cam)


def test_state_round_trip(world):
    _, _, cam, flags = world
    tcfg = _port(_cfg(flags, "SVGF"))
    state = tfused.init_state(tcfg, _port_cam(cam), "cpu")
    g = np.random.default_rng(2)
    state = state._replace(
        looper=7, iteration=3,
        accum=torch.as_tensor(g.random((3, W * H), dtype=np.float32)),
        pt_pack=torch.as_tensor(g.random((tk.PT_CH, W * H),
                                         dtype=np.float32)))
    mesh = make_mesh(["cpu"] * 2)
    banded = shard_fused_state(state, mesh)
    assert isinstance(banded.pt_pack, list) and len(banded.pt_pack) == 2
    assert banded.pt_pack[1].shape == (tk.PT_CH, W * H // 2)
    back = gather(banded, "cpu")
    assert back.looper == 7 and back.iteration == 3
    for f in ("accum", "pt_pack", "svgf_pack", "accum_ind", "gi_q"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f


def test_mesh_defaults_to_the_cuda_devices():
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    else:
        assert all(d.type == "cuda" for d in make_mesh())
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2

