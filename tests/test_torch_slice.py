"""The port's fused DI frame against the JAX package's, end to end.

`restir_tpu.models.restir_di_fused.step_fused(interpret=True)` and the
port's `step_fused` (plain twins, CPU) run three RESTIR_DI + EAW frames
of many_light_scene(16, 6) at 128x32 from the same converted state, the
camera moving on the last frame. Frame 0's G-buffer and reuse packs hold
the parity gates; every frame's image holds the image gates (a rare RIS
pick flip spreads through the reuse, hence a fraction bound). The rest
covers the renderer API, determinism and JAX checkpoints.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from restir_tpu import renderer as jrenderer
from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert, parity
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.models import restir_di_fused as tfused
from restir_tpu_torch.ops.camera import pack_camera
from restir_tpu_torch.ops.kernels import fused_di as tk
from restir_tpu_torch.ops.kernels import gbuffer
from restir_tpu_torch.scene.procedural import many_light_scene as t_scene
from restir_tpu_torch.scene.scene_data import _build_fused_atlas

W, H = 128, 32
R = W * H


def _port_cfg(cfg):
    return tconfig.RenderConfig(**dataclasses.asdict(cfg))


def _port_cam(cam):
    return convert.camera_from_numpy([np.asarray(x) for x in cam])


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=6,
                                    bvh_impl="numpy")
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.EAW, ris_mode="cdf",
                       **mat_flags(scene))
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.3, 4.5, 15.0)})
    cams = [cam0, cam0, cam1]
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, cfg, cams


def _leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state)]


@pytest.fixture(scope="module")
def jax_run(world, tmp_path_factory):
    """Leaves of the JAX state before and after each frame (as numpy: the
    JAX step donates its accumulator), the frames, and a checkpoint of
    the state after frame 2 written by restir_tpu.renderer."""
    scene, _, cfg, cams = world
    state = jfused.init_state(cfg, cams[0])
    states, frames = [_leaves(state)], []
    ckpt = str(tmp_path_factory.mktemp("jax") / "fused_state.npz")
    for i, cam in enumerate(cams):
        if i == 2:
            jrenderer.save_checkpoint(ckpt, state)
        state, frame = jfused.step_fused(scene, state, cam, cfg,
                                         interpret=True)
        states.append(_leaves(state))
        frames.append(np.asarray(frame).reshape(3, R))
    return states, frames, ckpt


def _port_frames(world, leaves0):
    _, tscene, cfg, cams = world
    tcfg = _port_cfg(cfg)
    state = convert.state_from_numpy(leaves0, tcfg, "cpu")
    frames = []
    for cam in cams:
        state, frame = tfused.step_fused(tscene, state, _port_cam(cam), tcfg)
        frames.append(frame.clone().numpy())
    return state, frames


def _image_gates(want, got):
    mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-9)
    frac = np.isclose(want, got, rtol=1e-3, atol=1e-6).mean()
    return mean_rel, frac


def test_frame0_packs_match_jax(world):
    scene, tscene, cfg, cams = world
    cv = fk.pack_camera(cams[0], W, H)
    gb_j, pt_j = fk.di_resident_pallas(
        cv, cv, jnp.uint32(0), jnp.zeros((fk.PT_CH, R)),
        scene.tri_xform, scene.prim_attr, scene.mat_attr,
        scene.light_verts, scene.light_normal, scene.light_radiance,
        scene.light_area, scene.light_center, scene.light_radius,
        width=W, height=H, k=cfg.cdf_candidates,
        temporal_clamp=cfg.temporal_clamp, has_met=cfg.scene_has_metallic,
        interpret=True)
    tcv = torch.tensor(np.asarray(cv))
    gb_t, pt_t = tk.di_resident(tcv, tcv, 0, torch.zeros(tk.PT_CH, R),
                                tscene.tables, tscene.bvh, width=W, height=H,
                                k=cfg.cdf_candidates,
                                has_met=cfg.scene_has_metallic)
    fails, stats = parity.gb_pt_report(gb_j, pt_j, gb_t, pt_t)
    assert not fails, (fails, stats)


def test_three_frames_match_jax(world, jax_run):
    states, jframes, _ = jax_run
    tstate, tframes = _port_frames(world, states[0])
    for i, (want, got) in enumerate(zip(jframes, tframes)):
        assert got.shape == (3, R) and np.isfinite(got).all()
        mean_rel, frac = _image_gates(want, got)
        assert mean_rel < 0.01, (i, mean_rel)
        assert frac >= 0.99, (i, frac)
    # the reuse packs after the last frame pass the pack gates' pick test
    pt_j = states[-1][3].reshape(fk.PT_CH, R)
    same = np.all(pt_j[0:3] == tstate.pt_pack[0:3].numpy(), axis=0)
    assert same.mean() >= parity.PICK_MATCH_MIN
    assert tstate.looper == int(states[-1][0])
    assert tstate.iteration == int(states[-1][1])


def test_port_is_deterministic(world, jax_run):
    states = jax_run[0]
    _, a = _port_frames(world, states[0])
    _, b = _port_frames(world, states[0])
    for fa, fb in zip(a, b):
        assert np.array_equal(fa, fb)


def test_renderer_api(world, tmp_path):
    _, tscene, cfg, cams = world
    tcfg = _port_cfg(cfg)
    cam = _port_cam(cams[0])
    state = trenderer.init_state(tcfg, cam, tscene, device="cpu")
    assert state.pt_pack.shape == (tk.PT_CH, R)
    for _ in range(2):
        state, frame = trenderer.step(tscene, state, cam, tcfg)
    img = trenderer.frame_to_image(frame, tcfg)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (H, W, 3)
    assert int(img.max()) > 0
    assert float(state.pt_pack[tk.P_M].max()) > tcfg.cdf_candidates

    path = str(tmp_path / "port.npz")
    trenderer.save_checkpoint(path, state)
    back = trenderer.load_checkpoint(path, tcfg, cam, tscene, device="cpu")
    assert back.looper == state.looper and back.iteration == state.iteration
    assert torch.equal(back.accum, state.accum)
    assert torch.equal(back.pt_pack, state.pt_pack)

    reset = trenderer.reset_accumulation(state)
    assert reset.iteration == 0 and reset.looper == state.looper
    assert float(reset.accum.abs().sum()) == 0.0


def test_checkpoint_from_jax_state_loads(world, jax_run):
    _, tscene, cfg, cams = world
    states, jframes, ckpt = jax_run
    tcfg = _port_cfg(cfg)
    state = trenderer.load_checkpoint(ckpt, tcfg, _port_cam(cams[0]),
                                      tscene, device="cpu")
    ref = states[2]
    assert state.looper == 2 and state.iteration == 2
    assert np.array_equal(state.accum.numpy(), ref[2].reshape(3, R))
    assert np.array_equal(state.pt_pack.numpy(), ref[3].reshape(fk.PT_CH, R))
    for a, b in zip(state.last_camera, ref[7:]):
        assert np.array_equal(a.numpy(), b)
    # continuing from the loaded state reproduces the JAX third frame
    _, frame = trenderer.step(tscene, state, _port_cam(cams[2]), tcfg)
    mean_rel, frac = _image_gates(jframes[2], frame.numpy())
    assert mean_rel < 0.01 and frac >= 0.99, (mean_rel, frac)
    # and the port writes the JAX leaf layout back
    leaves = convert.state_to_numpy(state)
    assert [np.shape(x) for x in leaves] == [x.shape for x in ref]


def test_large_scene_raises():
    """Scenes over 1024 triangles take the MTBVH path, textured ones too:
    a large scene whose floor reads a texture initialises and renders a
    frame on the CPU, and the texture shows in the albedo."""
    arrays, camkw = t_scene(16, 120)
    scene = convert.scene_from_numpy(arrays, "cpu")
    assert scene.num_tris > tfused.RESIDENT_MAX_TRIS
    cfg = tconfig.RenderConfig(width=W, height=H, **tconfig.mat_flags(arrays))
    cam = convert.camera_from_numpy(
        [np.asarray(x) for x in make_camera(**camkw)])
    state = trenderer.init_state(cfg, cam, scene, device="cpu")
    assert state.pt_pack.shape == (tk.PT_CH, R)
    checker = (np.indices((32, 32)).sum(0) % 2).astype(np.float32)
    tex = np.stack([checker, 0.5 * checker + 0.25,
                    np.full_like(checker, 0.5)], axis=-1)
    atlas, meta = _build_fused_atlas([tex])
    mat_attr = arrays.mat_attr.copy()
    mat_attr[0, 7] = 0.0  # the floor reads texture 0
    textured = convert.scene_from_numpy(
        arrays._replace(mat_attr=mat_attr, fused_atlas=atlas,
                        fused_tex_meta=meta), "cpu")
    assert textured.has_textures
    tcfg = cfg.replace(with_textures=True)
    state = trenderer.init_state(tcfg, cam, textured, device="cpu")
    state, frame = trenderer.step(textured, state, cam, tcfg)
    assert tuple(frame.shape) == (3, R) and bool(torch.isfinite(frame).all())
    assert float(frame.mean()) > 0.0
    # the floor's albedo is the checker's texels, not its base colour
    gb = gbuffer.gbuffer_pack(pack_camera(cam), pack_camera(cam), 0,
                              textured.bvh, width=W, height=H,
                              with_textures=True)
    red = gb[tk.G_ALB][gb[tk.G_PRIMR] == 0.0]
    assert red.numel() > 100
    assert float(red.std()) > 0.1 and float(red.min()) < 0.5  # base is 0.65
