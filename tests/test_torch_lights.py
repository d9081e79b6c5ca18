"""The port's light sampling against the JAX package's, on the CPU.

The alias tables and the scene leaves the general path reads must equal
the JAX build's bit for bit (float64 build, float32 result, the same
stack order), and the NEE, env-map and light-CDF samplers must agree at
the same uniforms. The uniforms come from numpy; both packages get the
same arrays.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.ops import lights as jlights
from restir_tpu.scene import alias_table as jalias
from restir_tpu.scene.loader import parse_scene_file as j_parse
from restir_tpu.scene.procedural import env_scene as j_env_scene
from restir_tpu.scene.procedural import many_light_scene as j_scene
from restir_tpu.utils import math as jmath
from restir_tpu_torch import convert
from restir_tpu_torch.ops import lights as tlights
from restir_tpu_torch.scene import alias_table as talias
from restir_tpu_torch.scene.loader import parse_scene_file as t_parse
from restir_tpu_torch.scene.procedural import env_scene as t_env_scene
from restir_tpu_torch.scene.procedural import many_light_scene as t_scene

NEW_LEAVES = ("light_prob", "light_alias", "sum_light_power_inv", "env_prob",
              "env_alias", "mat_base_color", "mat_metallic", "mat_roughness",
              "mat_ior", "mat_base_map", "mat_metallic_map",
              "mat_roughness_map", "mat_normal_map")
N = 2048


def _scenes(name):
    if name == "many_light":
        return (j_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")[0],
                t_scene(8, 4)[0])
    if name == "env":
        return j_env_scene(bvh_impl="numpy")[0], t_env_scene()[0]
    return (j_parse("scenes/cornell.txt").build(bvh_impl="numpy"),
            t_parse("scenes/cornell.txt").build())


@pytest.fixture(scope="module", params=["many_light", "env", "cornell"])
def scenes(request):
    jscene, tarrays = _scenes(request.param)
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")
    return request.param, jscene, tarrays, tscene


def test_scene_leaves_equal_jax(scenes):
    _, jscene, tarrays, _ = scenes
    for name in NEW_LEAVES:
        want = np.asarray(getattr(jscene, name))
        got = np.asarray(getattr(tarrays, name))
        assert want.dtype == got.dtype, name
        assert np.array_equal(want, got), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alias_table_equals_jax(seed):
    g = np.random.default_rng(seed)
    w = g.random(257) ** 4 * (g.random(257) > 0.3)
    j, t = jalias.build_alias_table(w), talias.build_alias_table(w)
    assert np.array_equal(np.asarray(j.prob), t.prob)
    assert np.array_equal(np.asarray(j.fail_id), t.fail_id)
    assert j.sum_all == t.sum_all
    r1, r2 = g.random((2, 4096), dtype=np.float32)
    want = jalias.sample_alias(j.prob, j.fail_id, jnp.asarray(r1),
                               jnp.asarray(r2))
    got = talias.sample_alias(torch.as_tensor(t.prob),
                              torch.as_tensor(t.fail_id), torch.as_tensor(r1),
                              torch.as_tensor(r2))
    assert np.array_equal(np.asarray(want), got.numpy())


def _points(tscene, seed):
    """Shading points on the scene's triangles with their normals, and
    four uniforms per lane."""
    g = np.random.default_rng(seed)
    verts = tscene.verts.numpy()
    tri = g.integers(0, verts.shape[0], N)
    b = g.random((N, 2)).astype(np.float32)
    b = np.where(b.sum(-1, keepdims=True) > 1, 1 - b, b)
    v = verts[tri]
    pos = (v[:, 0] + b[:, :1] * (v[:, 1] - v[:, 0])
           + b[:, 1:] * (v[:, 2] - v[:, 0])).astype(np.float32)
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    pos = pos + 1e-3 * n
    u = g.random((4, N), dtype=np.float32)
    return pos, n, u


def _close(name, want, got, rtol=1e-5, atol=1e-6, frac=1.0):
    want, got = np.asarray(want), got.numpy()
    ok = np.isclose(want, got, rtol=rtol, atol=atol)
    assert ok.mean() >= frac, (name, ok.mean())


def test_nee_samples_agree(scenes):
    name, jscene, _, tscene = scenes
    pos, _, u = _points(tscene, 3)
    has_env = name == "env"
    want = jlights.sample_direct_light_no_visibility(
        jscene, jnp.asarray(pos), *map(jnp.asarray, u), has_env=has_env)
    got = tlights.sample_direct_light_no_visibility(
        tscene, torch.as_tensor(pos), *map(torch.as_tensor, u),
        has_env=has_env)
    for field in want._fields:
        _close(field, getattr(want, field), getattr(got, field))


def test_env_map_pdf_agrees():
    jscene, _ = _scenes("env")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")
    g = np.random.default_rng(4)
    w = g.standard_normal((N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    want = jlights.env_map_pdf(jscene, jnp.asarray(w))
    got = tlights.env_map_pdf(tscene, torch.as_tensor(w))
    _close("env pdf", want, got)


def _jax_targets(scene, pos, norm, single_sided, has_env):
    """The target matrix that `restir_tpu.ops.lights.sample_light_cdf`
    builds (lights.py:152-218), op for op."""
    nl = scene.light_verts.shape[0]
    lc, ln = scene.light_center, scene.light_normal
    n_dot_x = jmath.dot(norm, pos)
    a = (jnp.concatenate([norm, -n_dot_x[..., None]], -1)
         @ jnp.concatenate([lc, jnp.ones((nl, 1))], -1).T)
    b = (jnp.concatenate([pos, jnp.ones_like(n_dot_x[..., None])], -1)
         @ jnp.concatenate([ln, -jnp.sum(ln * lc, -1, keepdims=True)], -1).T)
    x2 = jnp.sum(pos * pos, -1)
    c2 = jnp.sum(lc * lc, -1)
    d2 = jnp.maximum(
        jnp.concatenate([-2.0 * pos, jnp.ones_like(x2[..., None]),
                         x2[..., None]], -1)
        @ jnp.concatenate([lc, c2[..., None], jnp.ones((nl, 1))], -1).T, 1e-8)
    lum_area = jmath.luminance(scene.light_radiance) * scene.light_area
    side = b > 0.0 if single_sided else jnp.abs(b) > 0.0
    rad = scene.light_radius
    t = jnp.where(((a + rad[None, :]) > 0.0) & side,
                  lum_area[None, :] * jnp.maximum(a, 0.1 * rad[None, :])
                  * jnp.abs(b) / (d2 * d2), 0.0)
    if has_env:
        uv = scene.env_tile_uv
        a_env = norm @ jmath.to_sphere(uv[:, 0:2] + 0.5 * uv[:, 2:4]).T
        ang = 0.5 * jnp.sqrt((jmath.PI * uv[:, 3]) ** 2
                             + (jmath.TWO_PI * uv[:, 2]) ** 2)
        lum_sa = jmath.luminance(scene.env_tile_rad) * scene.env_tile_sa
        t = jnp.concatenate([t, jnp.where(
            (a_env + ang[None, :]) > 0.0,
            lum_sa[None, :] * jnp.maximum(a_env, 0.1 * ang[None, :]), 0.0)],
            -1)
    return t


@pytest.mark.parametrize("single_sided", [True, False])
def test_light_cdf_samples_agree(scenes, single_sided):
    name, jscene, _, tscene = scenes
    pos, n, u = _points(tscene, 5)
    has_env = name == "env"
    jpos, jn = jnp.asarray(pos), jnp.asarray(n)
    tpos, tn = torch.as_tensor(pos), torch.as_tensor(n)
    tu = tuple(map(torch.as_tensor, u[:3]))
    want = jlights.sample_light_cdf(
        jscene, jpos, jn, *map(jnp.asarray, u[:3]),
        single_sided=single_sided, has_env=has_env)
    # the draw: from the JAX package's own target matrix, every lane picks
    # the same light and agrees to 1e-5
    jt = np.array(_jax_targets(jscene, jpos, jn, single_sided, has_env))
    got = tlights.sample_from_targets(tscene, torch.as_tensor(jt), tpos, *tu,
                                      single_sided, has_env)
    assert np.array_equal(np.asarray(want.radiance), got.radiance.numpy())
    for field in want._fields:
        _close(field, getattr(want, field), getattr(got, field))
    # the whole sampler: where the port's target row equals the JAX one
    # bit for bit, every field agrees to 1e-5. XLA sums the small
    # [R, 4] @ [4, L] products in an order that depends on L, and the
    # expanded |x - c|^2 = x.x - 2 x.c + c.c cancels, so on the other lanes
    # a target moves by ~1e-4 relative: a threshold near a CDF step may
    # pick the neighbouring light, and the pdf (selection probability x
    # area term) moves with the total. Those lanes are counted.
    tt = tlights.light_targets(tscene, tpos, tn, single_sided, has_env)
    row_eq = np.all(tt.numpy() == jt, -1)
    got = tlights.sample_light_cdf(tscene, tpos, tn, *tu,
                                   single_sided=single_sided, has_env=has_env)
    for field in want._fields:
        _close(field, np.asarray(getattr(want, field))[row_eq],
               getattr(got, field)[torch.as_tensor(row_eq)])
    same = (np.all(np.asarray(want.radiance) == got.radiance.numpy(), -1)
            & np.all(np.isclose(np.asarray(want.wi), got.wi.numpy(),
                                rtol=1e-4, atol=1e-5), -1))
    assert same.mean() >= 0.99, same.mean()
    wp, gp = np.asarray(want.pdf)[same], got.pdf.numpy()[same]
    assert np.isclose(wp, gp, rtol=1e-3, atol=1e-6).mean() >= 0.998
    assert (~np.isclose(wp, gp, rtol=1e-5, atol=1e-6)).sum() <= 0.12 * N
