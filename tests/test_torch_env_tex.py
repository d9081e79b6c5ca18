"""The port's env-map and texture branches against the JAX package's.

On the CPU, at 128x16:
- `env_scene` and `textured_scene(aux_maps=True)` built by the port equal
  the JAX SceneData leaves exactly, env tiles and texture atlas included;
  the atlas takes the same box-mip for a texture wider than 128 texels;
- the env rows of the light tables equal `ris_kernel.build_light_tables`'
  and the texture / env / procedural helpers equal the JAX kernel's
  (`_tex_bilinear`, `_procedural_tex` with uvs beyond [0, 1),
  `_env_tile_radiance`);
- the B1 twin with `has_env` / `with_textures` against
  `fused_di.di_resident_pallas(interpret=True)` under the parity gates;
- the B6 / B7 twins against the B1 twin on those scenes;
- three frames of `step_fused` (+ EAW) on each scene against the JAX
  `step_fused(interpret=True)` under the image gates.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.config import DenoiserType, RenderConfig, TracerType, mat_flags
from restir_tpu.models import restir_di_fused as jfused
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.ops.pallas import ris_kernel as rk
from restir_tpu.scene import procedural as jproc
from restir_tpu.scene import scene_data as jsd
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert, parity
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.ops.kernels import fused_di as tk
from restir_tpu_torch.ops.kernels import gbuffer, reuse, tables
from restir_tpu_torch.scene import procedural as tproc
from restir_tpu_torch.scene import scene_data as tsd

W, H = 128, 16
R = W * H
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "env": ("env_scene", {}, dict(has_env=True)),
    "textures": ("textured_scene", {"aux_maps": True},
                 dict(with_textures=True)),
}


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module", params=sorted(SCENES))
def world(request):
    fn, kw, flags = SCENES[request.param]
    js, camkw = getattr(jproc, fn)(bvh_impl="numpy", **kw)
    ts, tcamkw = getattr(tproc, fn)(**kw)
    cam0 = make_camera(**camkw)
    pos = camkw["position"]
    cam1 = make_camera(**{**camkw, "position": (pos[0] + 0.2, pos[1],
                                                pos[2])})
    scene = convert.scene_from_numpy(ts, "cpu")
    return dict(name=request.param, js=js, ts=ts, camkw=camkw,
                tcamkw=tcamkw, cams=[cam0, cam0, cam1], scene=scene,
                flags=flags)


@pytest.mark.parametrize("field", tsd.SceneArrays._fields)
def test_scene_leaves_equal(world, field):
    want = np.asarray(getattr(world["js"], field))
    got = getattr(world["ts"], field)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert world["camkw"] == world["tcamkw"]


def test_atlas_mips_wide_textures():
    """A 256-wide texture is box-mipped to 128 as the JAX atlas does; the
    row budget shrinks the tallest texture."""
    g = np.random.default_rng(8)
    texs = [g.random((64, 256, 3), dtype=np.float32),
            g.random((200, 100, 3), dtype=np.float32),
            g.random((16, 128, 3), dtype=np.float32)]
    want = jsd._build_fused_atlas(texs)
    got = tsd._build_fused_atlas(texs)
    for a, b in zip(want, got):
        assert a.shape == b.shape and np.array_equal(a, b)
    meta = got[1]
    assert tuple(meta[0, 1:3]) == (128, 32)  # 256 x 64 -> one mip level
    # the device texels carry the same values in [row, x] order
    texels = tables.atlas_texels(got[0]).reshape(-1, 128, 4)
    r0, w, h = (int(v) for v in meta[2, 0:3])
    np.testing.assert_array_equal(texels[r0:r0 + h, :w, 0:3], texs[2])


def test_env_light_rows_match_jax(world):
    t = world["scene"].tables
    if world["name"] != "env":
        # no env map: no env rows, and asking for them is an error
        assert t.env_lights is None and not world["scene"].has_env_map
        with pytest.raises(ValueError, match="no env map"):
            t.light_rows(True)
        return
    js = world["js"]
    nl = js.light_verts.shape[0]
    l_pad = -(-max(nl + 512, 128) // 128) * 128
    psi_a, psi_b, psi_c, lum_aux, _, light_t = rk.build_light_tables(
        js.light_verts, js.light_normal, js.light_radiance, js.light_area,
        js.light_center, js.light_radius, l_pad,
        env_tile_rad=js.env_tile_rad, env_tile_uv=js.env_tile_uv,
        env_tile_sa=js.env_tile_sa)
    lights, psi = (x.numpy() for x in t.light_rows(True))
    assert lights.shape == (l_pad, 16) and t.n_lights == nl
    want_psi = np.concatenate([np.asarray(psi_a), np.asarray(psi_b),
                               np.asarray(psi_c), np.asarray(lum_aux)],
                              axis=1)
    np.testing.assert_allclose(psi[:, 0:15], want_psi, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(lights, np.asarray(light_t).T)
    # without has_env the area-only tables stay as before
    assert t.light_rows(False)[0].shape[0] == 128


def test_texture_helpers_match_jax(world):
    """Bilinear fetch, procedural texture and env tile pick equal the JAX
    kernel's helpers, uvs beyond [0, 1) and float -> int saturation
    included."""
    g = np.random.default_rng(9)
    n = 4096
    # |u| > 2048 wraps the uint32 cell index (u * 1024 * 1024)
    u = np.concatenate([g.uniform(-3.0, 4.0, n - 8), [0.0, 0.99999994],
                        g.uniform(2100.0, 2200.0, 3),
                        g.uniform(-2200.0, -2100.0, 3)]).astype(np.float32)
    v = g.uniform(-2.0, 3.0, n).astype(np.float32)
    # float -> int32 truncates and saturates as XLA's convert does
    big = np.float32([3.0e12, -3.0e12, 2.2e9, -2.2e9, -0.5, 2.5, np.nan])
    assert np.array_equal(tk._trunc_i32(_t(big)).numpy(),
                          np.asarray(jnp.asarray(big).astype(jnp.int32)))
    want = np.asarray(fk._procedural_tex(jnp.asarray(u), jnp.asarray(v)))
    got = tk.procedural_tex(_t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    js, scene = world["js"], world["scene"]
    if world["name"] == "textures":
        atlas = jnp.asarray(js.fused_atlas)
        meta = np.asarray(js.fused_tex_meta)
        for tid in range(4):
            m = meta[tid]
            want = fk._tex_bilinear(
                atlas, tuple(jnp.full((n,), float(x), jnp.float32)
                             for x in (m[0], max(m[1], 1.0),
                                       max(m[2], 1.0))),
                jnp.asarray(u), jnp.asarray(v))
            got = tk.tex_bilinear(scene.tables.atlas, scene.tables.tex_meta,
                                  torch.full((n,), float(tid)), _t(u), _t(v))
            np.testing.assert_allclose(got.numpy(), np.stack(want),
                                       rtol=1e-6, atol=1e-7)
    else:
        d = g.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
        env8 = jnp.concatenate([jnp.asarray(js.env_tile_rad).T,
                                jnp.zeros((5, 512))])
        want = np.stack(fk._env_tile_radiance(env8, *map(jnp.asarray, d)))
        got = tk.env_tile_radiance(scene.tables.env_rad, *map(_t, d))
        np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_env_thresholds_match_twin():
    """csrc/di_core.cuh's tile thresholds are the twin's float32 values."""
    src = open(os.path.join(REPO, "restir_tpu_torch", "csrc",
                            "di_core.cuh")).read()

    def table(name):
        body = re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", src).group(1)
        return np.float32([float(x.strip().rstrip("f"))
                           for x in body.split(",")])

    assert np.array_equal(table("kEnvCosY"), tk.ENV_COS_Y)
    assert np.array_equal(table("kEnvAngX"), tk.ENV_ANG_X)
    want = np.float32([fk._pseudo_angle_const(2.0 * np.pi * s / 32)
                       for s in range(1, 32)])
    assert np.array_equal(tk.ENV_ANG_X, want)


@pytest.fixture(scope="module")
def history(world):
    """A JAX frame-0 pt pack with its weights and M re-drawn from a seed,
    so the temporal merge runs on random reservoirs."""
    js, cams, flags = world["js"], world["cams"], world["flags"]
    cv = fk.pack_camera(cams[0], W, H)
    _, pt0 = _jax_b1(js, cv, cv, 4, np.zeros((fk.PT_CH, R), np.float32),
                     flags)
    prev = np.asarray(pt0).reshape(fk.PT_CH, R).copy()
    g = np.random.default_rng(7)
    prev[fk.P_WEIGHT] = np.abs(g.normal(size=R)).astype(np.float32)
    prev[fk.P_M] = g.integers(1, 120, size=R).astype(np.float32)
    return prev


def _jax_b1(js, cv, lcv, looper, prev, flags):
    return fk.di_resident_pallas(
        cv, lcv, jnp.uint32(looper), jnp.asarray(prev),
        js.tri_xform, js.prim_attr, js.mat_attr,
        js.light_verts, js.light_normal, js.light_radiance,
        js.light_area, js.light_center, js.light_radius,
        width=W, height=H, k=4, env_tile_rad=js.env_tile_rad,
        env_tile_uv=js.env_tile_uv, env_tile_sa=js.env_tile_sa,
        fused_atlas=js.fused_atlas, fused_tex_meta=js.fused_tex_meta,
        has_met=True, interpret=True, **flags)


def test_b1_twin_matches_pallas(world, history):
    js, cams, flags, scene = (world["js"], world["cams"], world["flags"],
                              world["scene"])
    cv0 = fk.pack_camera(cams[0], W, H)
    cv1 = fk.pack_camera(cams[2], W, H)
    gb_j, pt_j = _jax_b1(js, cv1, cv0, 5, history, flags)
    gb_j = np.asarray(gb_j).reshape(fk.GB_CH, R)
    pt_j = np.asarray(pt_j).reshape(fk.PT_CH, R)
    gb_t, pt_t = tk.di_resident(_t(cv1), _t(cv0), 5, _t(history),
                                scene.tables, scene.bvh, width=W, height=H,
                                **flags)
    fails, stats = parity.gb_pt_report(gb_j, pt_j, gb_t, pt_t)
    assert not fails, (fails, stats)
    assert np.array_equal(pt_j[fk.P_M], pt_t[tk.P_M].numpy())
    alb = slice(fk.G_ALB, fk.G_ALB + 3)
    hit = gb_j[fk.G_PRIM] == gb_t[tk.G_PRIM].numpy()
    np.testing.assert_allclose(gb_t[alb].numpy()[:, hit], gb_j[alb][:, hit],
                               rtol=1e-4, atol=1e-5)
    if "has_env" in flags:
        miss = gb_j[fk.G_MISS] > 0.5
        assert miss.any() and (gb_j[alb][:, miss] > 0).all()
        # env winners exist and agree
        assert (pt_j[fk.P_DIST] > 1e7).any()
        assert np.array_equal(pt_j[fk.P_DIST] > 1e7,
                              pt_t[tk.P_DIST].numpy() > 1e7)
    else:
        mr = slice(fk.G_METAL, fk.G_ROUGH + 1)
        np.testing.assert_allclose(gb_t[mr].numpy()[:, hit],
                                   gb_j[mr][:, hit], rtol=1e-4, atol=1e-5)
        assert gb_t[fk.G_METAL].numpy()[hit].std() > 0.05


def test_b6_b7_twins_match_b1_twin(world, history):
    """B6's and B7's twins (the split chain) equal the B1 twin."""
    cams, flags, scene = world["cams"], world["flags"], world["scene"]
    cv0 = _t(fk.pack_camera(cams[0], W, H))
    cv1 = _t(fk.pack_camera(cams[2], W, H))
    gb1, pt1 = tk.di_resident(cv1, cv0, 5, _t(history), scene.tables,
                              scene.bvh, width=W, height=H, **flags)
    gb = gbuffer.gbuffer_pack(cv1, cv0, 5, scene.bvh, width=W, height=H,
                              **flags)
    pt = reuse.reuse(gb, _t(history), 5, scene.tables, scene.bvh, width=W,
                     has_env=flags.get("has_env", False))
    assert torch.equal(gb, gb1) and torch.equal(pt, pt1)


def test_three_frames_match_jax(world):
    js, cams, scene, name = (world["js"], world["cams"], world["scene"],
                             world["name"])
    cfg = RenderConfig(
        width=W, height=H, tracer=TracerType.RESTIR_DI, ris_mode="cdf",
        denoiser=DenoiserType.EAW,
        has_env_map=name == "env", with_textures=name == "textures",
        **mat_flags(js))
    state = jfused.init_state(cfg, cams[0])
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    tstate = convert.state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(state)], tcfg, "cpu")
    for i, cam in enumerate(cams):
        state, frame = jfused.step_fused(js, state, cam, cfg, interpret=True)
        want = np.asarray(frame).reshape(3, R)
        tcam = convert.camera_from_numpy([np.asarray(x) for x in cam])
        tstate, tframe = trenderer.step(scene, tstate, tcam, tcfg)
        got = tframe.numpy()
        assert got.shape == (3, R) and np.isfinite(got).all()
        mean_rel = abs(got.mean() - want.mean()) / max(abs(want.mean()),
                                                       1e-9)
        frac = np.isclose(want, got, rtol=1e-3, atol=1e-6).mean()
        assert mean_rel < 0.01 and frac >= 0.99, (i, mean_rel, frac)
    pt_j = np.asarray(state.pt_pack).reshape(fk.PT_CH, R)
    fails, stats = parity.pt_report(pt_j, tstate.pt_pack)
    assert not fails, (fails, stats)
