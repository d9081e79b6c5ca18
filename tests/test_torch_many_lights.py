"""The port on a scene past the light tables' shared-memory limits, on the
CPU, against the JAX package.

many_light_scene(1225, 24) has 2,450 light rows and 2,748 triangles: past
the tables B7's staged design (2,416 area rows) and B10's first design
(1,792 rows) staged whole in shared memory; on the card B7
(`csrc/reuse_bvh.cu`) and B10 (`csrc/ris_cdf.cu`) run their light search
(`csrc/ris_search.cuh`), which streams the rows through shared memory
and picks what a full scan picks, bit for bit. Here their plain twins
run:
- one frame of the port's general RESTIR_DI cdf step (`restir_direct`)
  against the JAX general step, with the gates of
  tests/test_torch_general.py: radiance and reservoir weights within
  rtol 1e-4 on >= 99.5 % of pixels, M equal on >= 99.9 %;
- B1's and B8's staged tables under their gates fit a block's shared
  memory, so no scene reaches their limits.
B7's twin against the JAX fused kernels on this scene is in
tests/test_torch_many_lights_fused.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from restir_tpu.config import RenderConfig, TracerType, mat_flags
from restir_tpu.models import gbuffer as jgb
from restir_tpu.models import restir_di as jdi
from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch.models import gbuffer as tgb
from restir_tpu_torch.models import restir_di as tdi
from restir_tpu_torch.ops import reservoir as trsv
from restir_tpu_torch.ops.kernels import fused_di, gi, reuse, ris_cdf

N_LIGHTS, N_BLOCKS = 1225, 24  # 2,450 light rows, 2,748 triangles


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=N_LIGHTS, n_blocks=N_BLOCKS,
                                    bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, camkw


def test_tables_pass_the_staged_builds(world):
    """The scene is past the tables B7's staged design and B10's first
    design staged whole, and the light search of both sizes its
    checkpoints for it: S = 48, its shared memory within a block's and
    two blocks to an SM."""
    _, tscene, _ = world
    t = tscene.tables
    assert t.n_lights == 2 * N_LIGHTS
    assert tscene.num_tris > fk._RESIDENT_MAX_TRIS
    assert t.psi.shape[0] * 32 * 4 > fused_di.SMEM_MAX  # B10's first design
    assert t.n_lights > 2416  # B7's staged design
    seg = reuse.seg_for(t.n_lights, False)
    assert seg == 48
    smem = reuse.smem_bytes(t.n_lights, False, t.n_lights, seg)
    assert ris_cdf.smem_bytes(t.n_lights) == smem <= fused_di.SMEM_MAX
    assert (reuse.SEARCH_BLOCKS_PER_SM * (smem + reuse.SMEM_BLOCK_RESERVED)
            <= reuse.SMEM_SM)


def test_general_cdf_step_matches_jax(world):
    """One general RESTIR_DI cdf frame (`restir_direct` on the G-buffer
    pass; the JAX side jitted, as its renderer runs it), port against
    JAX, with test_restir_direct_matches_jax's gates (fov 35:
    tests/test_torch_general.py's note on XLA's tan)."""
    scene, tscene, camkw = world
    w, h = 64, 32
    r = w * h
    cam = make_camera(**{**camkw, "fov_y": 35.0})
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       **mat_flags(scene))
    tcfg = tconfig.RenderConfig(**dataclasses.asdict(cfg))
    assert tdi.resolve_ris_mode(tcfg) == "cdf"

    @jax.jit  # as the JAX renderer runs its step
    def frame(scene, cam):
        gb, it, mat, d = jgb.render_gbuffer(scene, cam, cam, cfg,
                                            jnp.uint32(4))
        return jdi.restir_direct(
            scene, gb, jgb.empty_gbuffer(r), it, mat, d,
            jdi.rsv.zeros_direct(r), cfg, jnp.uint32(4))

    out, res = frame(scene, cam)
    tcam = convert.camera_from_numpy([np.asarray(x) for x in cam])
    tgbuf, tit, tmat, td = tgb.render_gbuffer(tscene, tcam, tcam, tcfg, 4)
    tout, tres = tdi.restir_direct(
        tscene, tgbuf, tgb.empty_gbuffer(r, "cpu"), tit, tmat, td,
        trsv.zeros_direct(r, "cpu"), tcfg, 4)

    def close(want, got):
        want = np.asarray(want).reshape(r, -1)
        got = got.numpy().reshape(r, -1)
        assert np.isfinite(got).all()
        return np.isclose(want, got, rtol=1e-4, atol=1e-6).all(-1).mean()

    assert close(out, tout) >= 0.995
    assert (np.asarray(res.m) == tres.m.numpy()).mean() >= 0.999
    assert close(res.weight, tres.weight) >= 0.995
    assert float(tout.mean()) > 0.0


@pytest.mark.parametrize("has_env", [False, True])
def test_b1_b8_limits_are_out_of_reach(has_env):
    """B1 runs at most 1,024 triangles (RESIDENT_MAX_TRIS), so at most
    1,024 area lights: with the 512 env tiles its tables pad to 1,536
    rows (196,608 B). B8 is held to the JAX GI gate of 1,024 triangles,
    so its alias table holds at most 1,024 rows of 32 B. Both fit a
    block's shared memory: neither wrapper's limit can be reached."""
    from restir_tpu_torch.models import restir_di_fused as tfused
    from restir_tpu_torch.ops.kernels import tables

    n = tfused.RESIDENT_MAX_TRIS
    v = np.zeros((n, 3, 3), np.float32)
    v[:, 1, 0] = v[:, 2, 2] = 1.0
    args = [v, np.tile([0.0, -1.0, 0.0], (n, 1)), np.ones((n, 3)),
            np.full(n, 0.5), v.mean(1), np.ones(n)]
    n_env = fused_di.ENV_TH * fused_di.ENV_TW if has_env else 0
    env = ([np.ones((n_env, 3)), np.tile([0.0, 0.0, 0.1, 0.1], (n_env, 1)),
            np.full(n_env, 0.01)] if has_env else [])
    lights, psi = tables.light_tables(*args, *env)
    assert psi.shape[0] == (1536 if has_env else 1024)
    assert psi.shape[0] * 32 * 4 <= fused_di.SMEM_MAX  # B1's check
    assert gi.MAX_TRIS * 8 * 4 <= fused_di.SMEM_MAX  # B8's check
