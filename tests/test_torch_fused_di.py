"""B1's plain twin against the JAX fused resident DI kernel.

`di_resident_ref` (what CPU tensors run) against
`fused_di.di_resident_pallas(interpret=True)` at 128x16, on the same
scene, cameras and previous reuse pack. The history is a JAX frame of a
nearby camera with its weights and M re-drawn from a numpy seed, so the
temporal merge runs on random reservoirs (a fully random pack, as in
tests/test_fused_di.py, never passes the similarity tests). Gates are
restir_tpu_torch.parity's, the JAX package's own.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import convert, parity
from restir_tpu_torch.ops.kernels import fused_di as tk

W, H = 128, 16
R = W * H


@pytest.fixture(scope="module")
def setup():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=6,
                                    bvh_impl="numpy")
    cam0 = make_camera(**camkw)
    cam1 = make_camera(**{**camkw, "position": (0.2, 4.45, 15.0)})
    cv0 = fk.pack_camera(cam0, W, H)
    cv1 = fk.pack_camera(cam1, W, H)
    _, pt0 = _jax(scene, cv0, cv0, 4, np.zeros((fk.PT_CH, R), np.float32),
                  aa_jitter=True, temporal=True)
    prev = np.asarray(pt0).reshape(fk.PT_CH, R).copy()
    g = np.random.default_rng(7)
    prev[fk.P_WEIGHT] = np.abs(g.normal(size=R)).astype(np.float32)
    prev[fk.P_M] = g.integers(1, 120, size=R).astype(np.float32)
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, cv0, cv1, prev


def _jax(scene, cv, lcv, looper, prev, *, aa_jitter, temporal):
    return fk.di_resident_pallas(
        cv, lcv, jnp.uint32(looper), jnp.asarray(prev),
        scene.tri_xform, scene.prim_attr, scene.mat_attr,
        scene.light_verts, scene.light_normal, scene.light_radiance,
        scene.light_area, scene.light_center, scene.light_radius,
        width=W, height=H, aa_jitter=aa_jitter, single_sided=True, k=4,
        temporal=temporal, temporal_clamp=20, interpret=True)


@pytest.mark.parametrize("temporal", [True, False])
@pytest.mark.parametrize("aa_jitter", [True, False])
def test_di_resident_twin_matches_pallas(setup, temporal, aa_jitter):
    scene, tscene, cv0, cv1, prev = setup
    gb_j, pt_j = _jax(scene, cv1, cv0, 5, prev, aa_jitter=aa_jitter,
                      temporal=temporal)
    gb_j = np.asarray(gb_j).reshape(fk.GB_CH, R)
    pt_j = np.asarray(pt_j).reshape(fk.PT_CH, R)

    def t(x):
        return torch.tensor(np.asarray(x))

    gb_t, pt_t = tk.di_resident(t(cv1), t(cv0), 5, t(prev), tscene.tables,
                                tscene.bvh, width=W, height=H,
                                aa_jitter=aa_jitter,
                                temporal=temporal)
    fails, stats = parity.gb_pt_report(gb_j, pt_j, gb_t, pt_t)
    assert not fails, (fails, stats)
    # on the CPU the two agree on every reservoir count
    assert np.array_equal(pt_j[fk.P_M], pt_t[tk.P_M].numpy())
    if temporal:
        # the history really merged: M grew past K on most shaded lanes
        shade = gb_j[fk.G_SHADE] > 0.5
        assert (pt_j[fk.P_M][shade] > 4).mean() > 0.5


def test_layout_constants_match():
    for name in ("G_POS", "G_NORM", "G_DIR", "G_ALB", "G_DEPTH", "G_MOTION",
                 "G_PRIMR", "G_MTYPE", "G_METAL", "G_ROUGH", "G_SHADE",
                 "G_LIGHT", "G_MISS", "G_PRIM", "G_X", "G_Y", "GB_CH",
                 "P_LI", "P_WI", "P_DIST", "P_WEIGHT", "P_M", "P_PRIMR",
                 "P_NORM", "P_DEPTH", "PT_CH", "LIGHT_ID"):
        assert getattr(tk, name) == getattr(fk, name), name
    assert tk.TILE == fk._TILE


def test_di_resident_rejects_env_and_textures(setup):
    """Env rows need a scene with an env map; on a scene without textures
    or procedural materials the texture branch changes nothing."""
    _, tscene, cv0, _, prev = setup
    t = torch.tensor(np.asarray(cv0))
    kw = dict(width=W, height=H)
    with pytest.raises(ValueError, match="no env map"):
        tk.di_resident(t, t, 0, torch.as_tensor(prev), tscene.tables,
                       tscene.bvh, has_env=True, **kw)
    plain = tk.di_resident(t, t, 0, torch.as_tensor(prev), tscene.tables,
                           tscene.bvh, **kw)
    textured = tk.di_resident(t, t, 0, torch.as_tensor(prev), tscene.tables,
                              tscene.bvh, with_textures=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(plain, textured))


def test_cuda_wrapper_checks_before_launch(setup):
    """The CUDA entry point validates shapes and devices before it needs
    a compiler or a card."""
    _, tscene, cv0, _, prev = setup
    t = torch.tensor(np.asarray(cv0))
    with pytest.raises(ValueError):
        tk.di_resident_cuda(t, t, 0, torch.as_tensor(prev[:, :1024]),
                            tscene.tables, tscene.bvh, width=W, height=H)
    with pytest.raises(ValueError):
        tk.di_resident_cuda(t, t, 0, torch.as_tensor(prev), tscene.tables,
                            tscene.bvh, width=W, height=H, k=tk.MAX_K + 1)
