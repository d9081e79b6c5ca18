"""B11 and B12's plain versions against the Pallas kernels they replace.

`ops.kernels.intersect`'s plain versions (what a CPU tensor runs, and
what the CUDA kernels are held against on the card) against
`intersect_closest_pallas`, `test_occlusion_pallas` and
`primary_hit_pallas` run with interpret=True, under the gates of
tests/test_pallas_kernels.py (the Pallas kernels use bf16-split matmuls,
the port exact float32), plus the miss lanes' material row. The CPU
primary-hit route is held lane for lane against the JAX package's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.ops import intersect_bf as j_bf
from restir_tpu.ops.camera import make_camera, pixel_centers, sample_rays
from restir_tpu.ops.pallas import intersect_kernel as jk
from restir_tpu.ops.primary import trace_primary as j_trace_primary
from restir_tpu.scene.loader import parse_scene_file
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu.scene.scene_data import traversal_arrays
from restir_tpu_torch import convert
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops.kernels import intersect as ki
from restir_tpu_torch.ops.primary import trace_primary as t_trace_primary

W, H = 64, 32


def _world(name):
    if name == "many_light":
        scene, camkw = many_light_scene(n_lights=8, n_blocks=4,
                                        bvh_impl="numpy")
        cam = make_camera(**camkw)
    else:
        sf = parse_scene_file("scenes/cornell.txt")
        scene, cam = sf.build(bvh_impl="numpy"), sf.make_camera()
    x, y = pixel_centers(W, H)
    half = jnp.full_like(x, 0.5)
    o, d = sample_rays(cam, W, H, x, y, half, half)
    # a quarter of the rays point away from the scene: misses
    d = np.asarray(d).copy()
    d[::4] = -d[::4]
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, np.asarray(o), d


@pytest.fixture(scope="module", params=["many_light", "cornell"])
def world(request):
    return _world(request.param)


@pytest.fixture(scope="module")
def ml_world():
    """The Pallas gates hold on the many-light scene, as in the JAX
    package's own tests: the Cornell box's edge-on walls put ~1 % of the
    camera rays on triangle edges, where the TPU kernels' bf16-split
    products and exact float32 may pick another triangle (they do so
    against the JAX package's own CPU route as well)."""
    return _world("many_light")


def _t(a):
    return torch.as_tensor(np.array(a))


def test_closest_twin_matches_pallas(ml_world):
    scene, tscene, o, d = ml_world
    trv = tix.traversal_arrays(tscene)
    prim, dist, bary = ki.closest_hit(trv, _t(o), _t(d))
    ref = jk.intersect_closest_pallas(scene.tri_xform, jnp.asarray(o),
                                      jnp.asarray(d), interpret=True)
    rp, gp = np.asarray(ref.prim_id), prim.numpy()
    assert (rp != gp).mean() < 0.005
    assert (gp < 0).mean() > 0.2  # the reversed rays miss
    hit = (rp == gp) & (rp >= 0)
    np.testing.assert_allclose(np.asarray(ref.dist)[hit], dist.numpy()[hit],
                               rtol=3e-4)
    np.testing.assert_allclose(np.asarray(ref.bary)[hit], bary.numpy()[hit],
                               rtol=3e-3, atol=5e-4)
    assert np.all(np.isinf(dist.numpy()[gp < 0]))
    # the oracle: Möller-Trumbore over the triangle soup
    oracle = tix.brute_force_closest(tscene.verts, _t(o), _t(d))
    assert (oracle.prim_id.numpy() != gp).mean() < 0.005


def test_closest_twin_matches_jax_cpu_route(world):
    """The plain version is the JAX package's CPU route. XLA sums the
    [R, 4] @ [4, 3N] products in an order that depends on the shapes, so
    an edge-on ray may pick the neighbouring triangle; every other lane
    agrees to the last bits."""
    scene, tscene, o, d = world
    trv = tix.traversal_arrays(tscene)
    active = np.arange(o.shape[0]) % 3 != 0
    prim, dist, bary = ki.closest_hit(trv, _t(o), _t(d), _t(active))
    ref = j_bf.intersect_closest_bf(scene.tri_xform, jnp.asarray(o),
                                    jnp.asarray(d), active=jnp.asarray(active))
    rp = np.asarray(ref.prim_id)
    same = rp == prim.numpy()
    assert same.mean() >= 0.998
    assert np.all(prim.numpy()[~active] == -1)
    hit = same & (rp >= 0)
    np.testing.assert_allclose(np.asarray(ref.dist)[hit], dist.numpy()[hit],
                               rtol=1e-6)
    # u = oo.x + t dd.x cancels near an edge: absolute 1e-5
    np.testing.assert_allclose(np.asarray(ref.bary)[hit], bary.numpy()[hit],
                               rtol=1e-5, atol=1e-5)


def test_any_hit_twin_matches_pallas(ml_world):
    scene, tscene, o, d = ml_world
    trv = tix.traversal_arrays(tscene)
    ref_hit = j_bf.intersect_closest_bf(scene.tri_xform, jnp.asarray(o),
                                        jnp.asarray(d))
    dist = np.asarray(ref_hit.dist)
    pos = o + d * np.where(np.isfinite(dist), dist, 1.0)[:, None]
    target = np.broadcast_to(np.float32([0.0, 0.0, 5.0]), pos.shape).copy()
    active = np.asarray(ref_hit.prim_id) >= 0
    got = ki.any_hit(trv, _t(pos), _t(target), _t(active)).numpy()
    want = np.asarray(jk.test_occlusion_pallas(
        scene.tri_xform, jnp.asarray(pos), jnp.asarray(target),
        active=jnp.asarray(active), interpret=True))
    # grazing shadow rays along walls may flip (test_pallas_kernels.py)
    assert (want != got).mean() < 0.02
    assert not got[~active].any()
    assert np.array_equal(got, np.asarray(j_bf.test_occlusion_bf(
        scene.tri_xform, jnp.asarray(pos), jnp.asarray(target),
        active=jnp.asarray(active))))


def test_primary_twin_matches_pallas(ml_world):
    scene, tscene, o, d = ml_world
    trv = tix.traversal_arrays(tscene)
    got = ki.primary_hit(trv, tscene.prim_attr, tscene.mat_attr, _t(o), _t(d))
    want = jk.primary_hit_pallas(scene.tri_xform, scene.prim_attr,
                                 scene.mat_attr, jnp.asarray(o),
                                 jnp.asarray(d), interpret=True)
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    prim_w, prim_g = want[0], got[0]
    assert (prim_w != prim_g).mean() < 0.005
    hit = (prim_w == prim_g) & (prim_w >= 0)
    for i in (3, 4):  # pos, norm (bf16-split matmuls on the TPU side)
        np.testing.assert_allclose(want[i][hit], got[i][hit], rtol=1e-3,
                                   atol=5e-4)
    np.testing.assert_allclose(want[5][hit], got[5][hit], rtol=1e-3,
                               atol=5e-4)
    assert np.array_equal(want[6][hit], got[6][hit])
    # a miss interpolates a zero row and reads material row 0 on both
    miss = (prim_w < 0) & (prim_g < 0)
    assert miss.mean() > 0.2
    row0 = np.asarray(scene.mat_attr)[0]
    for mp in (want[6][miss], got[6][miss]):
        assert np.array_equal(mp[:, :11],
                              np.broadcast_to(row0[:11], mp[:, :11].shape))
        assert np.all(mp[:, 11] == 0.0)
    for i in (2, 3, 4, 5):
        assert np.all(got[i][miss] == 0.0) and np.all(want[i][miss] == 0.0)
    assert np.all(np.isinf(got[1][miss]))


def test_trace_primary_cpu_route_matches_jax(world):
    scene, tscene, o, d = world
    jit_, jmat, jhit = j_trace_primary(scene, traversal_arrays(scene, "auto"),
                                       jnp.asarray(o), jnp.asarray(d), False)
    tit, tmat, thit = t_trace_primary(tscene, tix.traversal_arrays(tscene),
                                      _t(o), _t(d), False)
    same = np.asarray(jhit.prim_id) == thit.prim_id.numpy()
    assert same.mean() >= 0.998  # edge-on rays, as above
    valid = np.asarray(jit_.valid) & same
    assert np.array_equal(np.asarray(jit_.mat_id)[valid],
                          tit.mat_id.numpy()[valid])
    for name in ("pos", "norm", "uv"):
        np.testing.assert_allclose(np.asarray(getattr(jit_, name))[valid],
                                   getattr(tit, name).numpy()[valid],
                                   rtol=1e-5, atol=1e-6)
    for name in jmat._fields:
        assert np.array_equal(np.asarray(getattr(jmat, name))[valid],
                              getattr(tmat, name).numpy()[valid]), name
