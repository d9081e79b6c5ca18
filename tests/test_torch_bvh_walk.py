"""The port's MTBVH walk (the general path's "bvh" intersector) against
the JAX package's, on the CPU.

On many_light_scene(8, 4) (74 triangles) and many_light_scene(8, 1400)
(16,826 triangles, over the 16,384-triangle brute-force limit), from the
same rays (camera rays, bounce rays from the camera hits, shadow
segments to light points; numpy, seeded):
- `intersect_closest_bvh`, `test_occlusion_bvh` and `intersect_visualize`
  (the twins of kernels B13 and B14) equal the JAX loops on every lane:
  primitive ids, distance and barycentric bits, occlusion, descended-node
  counts; the any hit both as the JAX package calls it eagerly and inside
  jitted code (the port inside `utils.math.fused()`);
- `traversal_method` / `traversal_arrays` resolve "auto", "brute", "bvh"
  and "clustered" on both sides of the limit as the JAX package does,
  warning when "auto" takes the walk;
- the walk's tables hold each node's unpadded box and are built on first
  use only.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.ops import intersect as jix
from restir_tpu.ops.camera import make_camera, pixel_centers, sample_rays
from restir_tpu.scene import scene_data as jsd
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import convert
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops.kernels import intersect as tk
from restir_tpu_torch.ops.kernels import tables
from restir_tpu_torch.scene import scene_data as tsd
from restir_tpu_torch.utils import math as mathx

SIZES = {"small": (4, 64, 32), "large": (1400, 32, 16)}  # blocks, W, H


def _rays(scene, camkw, w, h, seed, dist=None):
    """Camera rays, bounce rays from their hits and shadow segments from
    those hits to light points (float32 numpy). `dist`: (o, d) -> the
    camera rays' hit distances, the JAX walk's if None."""
    cam = make_camera(**{**camkw, "fov_y": 35.0})
    x, y = pixel_centers(w, h)
    o, d = sample_rays(cam, w, h, x, y, jnp.full_like(x, 0.5),
                       jnp.full_like(y, 0.5))
    o, d = np.asarray(o), np.asarray(d)
    if dist is None:
        trv = jsd.traversal_arrays(scene, "bvh")
        t = np.asarray(jix.intersect_closest_bvh(
            trv, jnp.asarray(o), jnp.asarray(d)).dist)
    else:
        t = dist(o, d)
    g = np.random.default_rng(seed)
    r = o.shape[0]
    pos = np.where(np.isfinite(t)[:, None], o + d * np.where(
        np.isfinite(t), t, 0.0)[:, None], o).astype(np.float32)
    wi = g.normal(size=(r, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    bo = (pos + wi * np.float32(1e-4)).astype(np.float32)
    lv = np.asarray(scene.light_verts)
    pick = g.integers(0, lv.shape[0], size=r)
    u = g.random((r, 2)).astype(np.float32)
    uu = np.minimum(u[:, 0], 1 - u[:, 1])
    target = (lv[pick, 0] + uu[:, None] * (lv[pick, 1] - lv[pick, 0])
              + u[:, 1:2] * (lv[pick, 2] - lv[pick, 0])).astype(np.float32)
    active = g.random(r) < 0.9
    return {"camera": (o, d), "bounce": (bo, wi), "shadow": (pos, target),
            "active": active}


@pytest.fixture(scope="module", params=list(SIZES))
def world(request):
    blocks, w, h = SIZES[request.param]
    scene, camkw = many_light_scene(n_lights=8, n_blocks=blocks,
                                    bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    n = tscene.num_tris
    assert (n > tsd.BRUTE_FORCE_MAX_PRIMS) == (request.param == "large")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtrv = jsd.traversal_arrays(scene, "bvh")
    walk = tix.traversal_arrays(tscene, "bvh").walk
    return scene, tscene, jtrv, walk, _rays(scene, camkw, w, h, 7)


def _t(a):
    return torch.tensor(np.asarray(a))


def _same_bits(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want.view(np.int32) if want.dtype == np.float32
                          else want, got.view(np.int32)
                          if got.dtype == np.float32 else got)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_closest_bvh_matches_jax(world, kind):
    _, _, jtrv, walk, rays = world
    o, d = rays[kind]
    want = jix.intersect_closest_bvh(jtrv, jnp.asarray(o), jnp.asarray(d))
    prim, dist, bary = tix.intersect_closest_bvh(walk, _t(o), _t(d))
    _same_bits(want.prim_id, prim)
    _same_bits(want.dist, dist)
    _same_bits(want.bary, bary)
    assert (prim.numpy() >= 0).mean() > 0.3  # the rays hit something
    # inactive lanes are not walked and miss
    act = rays["active"]
    want = jix.intersect_closest_bvh(jtrv, jnp.asarray(o), jnp.asarray(d),
                                     active=jnp.asarray(act))
    prim, dist, bary = tix.intersect_closest_bvh(walk, _t(o), _t(d),
                                                 _t(act))
    _same_bits(want.prim_id, prim)
    _same_bits(want.dist, dist)
    assert (prim.numpy()[~act] == -1).all()
    assert np.isinf(dist.numpy()[~act]).all()


@pytest.mark.parametrize("compiled", [False, True])
def test_occlusion_bvh_matches_jax(world, compiled):
    """Eager JAX against the port as called outside a fused block, and
    jitted JAX (FMAs contracted) against the port inside `fused()`."""
    _, _, jtrv, walk, rays = world
    x, y = rays["shadow"]
    act = rays["active"]

    def jax_occ(x, y, a):
        return jix.test_occlusion_bvh(jtrv, x, y, active=a)

    fn = jax.jit(jax_occ) if compiled else jax_occ
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(act)))
    if compiled:
        with mathx.fused():
            got = tix.test_occlusion_bvh(walk, _t(x), _t(y), _t(act))
    else:
        got = tix.test_occlusion_bvh(walk, _t(x), _t(y), _t(act))
    assert np.array_equal(want, got.numpy())
    assert 0.0 < want[act].mean() < 1.0  # some segments blocked, some not
    assert not got.numpy()[~act].any()


def test_visualize_matches_jax(world):
    _, _, jtrv, walk, rays = world
    o, d = rays["camera"]
    want = jix.intersect_visualize(jtrv, jnp.asarray(o), jnp.asarray(d))
    got = tix.intersect_visualize(walk, _t(o), _t(d))
    _same_bits(want, got)
    assert got.dtype == torch.int32 and int(got.max()) > 4


@pytest.mark.parametrize("compiled", [False, True])
def test_intersect_triangle_matches_jax(compiled):
    g = np.random.default_rng(3)
    n = 4096
    o, d = (g.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    v = (2.0 * g.normal(size=(n, 3, 3))).astype(np.float32)

    def jax_tri(o, d, v):
        return jix.intersect_triangle(o, d, v[:, 0], v[:, 1], v[:, 2])

    fn = jax.jit(jax_tri) if compiled else jax_tri
    want = fn(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v))
    tv = _t(v)
    if compiled:
        with mathx.fused():
            got = tix.intersect_triangle(_t(o), _t(d), tv[:, 0], tv[:, 1],
                                         tv[:, 2])
    else:
        got = tix.intersect_triangle(_t(o), _t(d), tv[:, 0], tv[:, 1],
                                     tv[:, 2])
    for w, gt in zip(want, got):
        _same_bits(w, gt)
    assert 0.05 < float(got[0].float().mean()) < 0.95


@pytest.mark.parametrize("method", ["auto", "brute", "bvh", "clustered"])
def test_traversal_method_matches_jax(world, method):
    scene, tscene, _, _, _ = world
    big = tscene.num_tris > tsd.BRUTE_FORCE_MAX_PRIMS
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jsd.traversal_method(scene, method)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tsd.traversal_method(tscene, method)
        trv = tix.traversal_arrays(tscene, method)
    assert got == want == trv.method
    warns = method == "auto" and big
    assert bool(jw) == warns
    assert any("16384" in str(w.message) for w in tw) == warns
    assert (trv.walk is None) == (got == "brute")
    assert tix.traversal_arrays(tscene, method, walk=True).walk is not None


def test_walk_tables_hold_exact_boxes(world):
    scene, tscene, _, walk, _ = world
    box = np.asarray(scene.bvh_box).reshape(-1)
    rows = walk.rows.numpy()
    assert np.array_equal(rows[:, 0:3], np.asarray(scene.bounds_lo)[box])
    assert np.array_equal(rows[:, 4:7], np.asarray(scene.bounds_hi)[box])
    assert np.array_equal(rows[:, 3].view(np.int32),
                          np.asarray(scene.bvh_prim).reshape(-1))
    assert np.array_equal(rows[:, 7].view(np.int32),
                          np.asarray(scene.bvh_miss).reshape(-1))
    n = tscene.num_tris
    vr = walk.vert_rows.numpy()
    assert vr.shape == tscene.bvh.planes.shape
    assert np.array_equal(vr[:n, 0:9], np.asarray(scene.verts).reshape(n, 9))
    assert not vr[:n, 9:].any() and not vr[n:].any()
    assert walk.size == np.asarray(scene.bounds_lo).shape[0]


def test_walk_tables_are_built_on_first_use():
    scene, _ = many_light_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    assert not tscene.walk.built
    assert tix.traversal_arrays(tscene, "auto").walk is None
    assert not tscene.walk.built
    trv = tix.traversal_arrays(tscene, "bvh")
    assert tscene.walk.built and trv.walk is tscene.walk.get()
    assert isinstance(trv.walk, tables.WalkTables)


def test_intersector_dispatch_on_cpu(world):
    """ops.intersect's entry points take the walk's twins for a walk
    method and intersect_bf for "brute", whose hits the walk reproduces
    wherever a single triangle is nearest."""
    _, tscene, _, walk, rays = world
    o, d = (_t(a) for a in rays["bounce"])
    x, y = (_t(a) for a in rays["shadow"])
    bvh = tix.traversal_arrays(tscene, "bvh")
    hit = tix.intersect_closest(bvh, o, d)
    want = tix.intersect_closest_bvh(walk, o, d)
    assert all(torch.equal(a, b) for a, b in zip(hit, want))
    assert torch.equal(tix.test_occlusion(bvh, x, y),
                       tix.test_occlusion_bvh(walk, x, y))
    brute = tix.traversal_arrays(tscene, "brute")
    bf = tix.intersect_closest(brute, o, d)
    assert torch.equal(bf.prim_id, tk.closest_plain(brute, o, d)[0])
    assert (bf.prim_id == hit.prim_id).float().mean() > 0.99
