"""B13's closest hit in sorted ray order (the ray query), on the CPU.

The card keys each ray (`ops.kernels.ray_order.ray_key`: the walk's
class, then a direction cell and the origin's Morton code), sorts the
keys and walks the rays in that order, writing each result at its ray's
index. Here, on many_light_scene(8, 4) (74 triangles) at 64x32 with
`test_torch_bvh_walk.py`'s camera and bounce rays plus edge rays:
- the key's torch twin against a numpy rendition: the class bits of
  seeded rays in all 24 classes (table of -d, inverse-direction signs),
  of components 0.0, -0.0 and +-1e-13, the `slab` class of infinite
  direction and origin components, the dead key of NaN rays and inactive
  lanes, and every low bit;
- the twin keys, torch.sort(stable=True), the walk's plain version on
  the sorted rays and a scatter back equal the JAX package's
  `intersect_closest_bvh` bit for bit (prim_id, dist, bary), with and
  without `active`, as `test_torch_bvh_walk.py` holds the unsorted twin;
- the permutation covers every ray once, dead lanes last;
- the wrapper sorts a batch between QUERY_SORT_MIN and QUERY_SORT_MAX
  rays only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.ops import intersect as jix
from restir_tpu.scene import scene_data as jsd
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import convert
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops.kernels import intersect as tk
from restir_tpu_torch.ops.kernels import ray_order as ro
from test_torch_bvh_walk import _rays, _same_bits


def _classes_np(o, d):
    """(table, class) of each ray from the definitions: the MTBVH table of
    -d (scene.h's dominant axis, ties to y then z), the signs of
    1 / d with |d| clamped to 1e-12 (-0.0 counts positive), class 24 for
    an infinite component."""
    n = -d
    ax, ay, az = np.abs(n).T
    table = np.where((ax > ay) & (ax > az), np.where(n[:, 0] > 0, 0, 1),
                     np.where((ay >= ax) & (ay > az),
                              np.where(n[:, 1] > 0, 2, 3),
                              np.where(n[:, 2] > 0, 4, 5)))
    with np.errstate(divide="ignore", over="ignore"):
        ds = np.where(np.abs(d) < 1e-12, np.where(d < 0, -1e-12, 1e-12), d)
        neg = np.signbit(np.float32(1.0) / ds.astype(np.float32))
    axis = table // 2
    lower = np.where(axis == 0, 1, 0)
    higher = np.where(axis == 2, 1, 2)
    i = np.arange(d.shape[0])
    cls = table * 4 + neg[i, lower] + 2 * neg[i, higher]
    slab = np.isinf(d).any(1) | np.isinf(o).any(1)
    return table, np.where(slab, 24, cls)


def _cell_np(p, lo, ext, bits):
    with np.errstate(invalid="ignore", divide="ignore"):
        u = (np.float32(p) - np.float32(lo)) / np.float32(ext)
    u = np.where(u >= 0, u, np.float32(0))
    u = np.minimum(u, np.float32(0.99999994))
    return (u * np.float32(1 << bits)).astype(np.int64)


def _key_np(o, d, active, rows):
    """The ray key in numpy, float32 op by op: class (5 bits), the
    origin's Morton code (5 bits an axis), two 2-bit direction cells."""
    db, mb = 2, 5
    table, cls = _classes_np(o, d)
    lo = rows[0, 0:3]
    ext = (rows[0, 4:7] - lo).astype(np.float32)
    axis = table // 2
    lower = np.where(axis == 0, 1, 0)
    higher = np.where(axis == 2, 1, 2)
    i = np.arange(d.shape[0])
    ad = np.abs(d)
    m = ad[i, axis]
    direction = ((_cell_np(ad[i, lower], 0.0, m, db) << db)
                 | _cell_np(ad[i, higher], 0.0, m, db))
    code = np.zeros(d.shape[0], np.int64)
    q = [_cell_np(o[:, a], lo[a], ext[a], mb) for a in range(3)]
    for b in range(mb):
        for a in range(3):
            code |= ((q[a] >> b) & 1) << (3 * b + a)
    key = (cls << 19) | (code << (2 * db)) | direction
    dead = np.isnan(o).any(1) | np.isnan(d).any(1) | ~active
    return np.where(dead, 2 ** 24 - 1, key).astype(np.int32), cls


@pytest.fixture(scope="module")
def small():
    scene, camkw = many_light_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    jtrv = jsd.traversal_arrays(scene, "bvh")
    walk = tix.traversal_arrays(tscene, "bvh").walk
    # the camera hits that place the bounce rays come from the walk's
    # twin, which writes the JAX walk's bits (test_torch_bvh_walk.py),
    # so the JAX walk runs once, in `jax_hits`
    return jtrv, walk, _rays(scene, camkw, 64, 32, 7, lambda o, d: (
        tix.intersect_closest_bvh(walk, torch.tensor(o), torch.tensor(d))[1]
        .numpy()))


def _class_rays(seed, n_per=40):
    """Rays in each of the 24 classes: for every table (axis, sign of -d)
    and every sign of the two other components, |d_axis| the largest."""
    g = np.random.default_rng(seed)
    o, d, want = [], [], []
    for table in range(6):
        axis, negd = table // 2, table % 2 == 0  # table 2a: -d_a > 0
        others = [a for a in range(3) if a != axis]
        for signs in range(4):
            v = g.uniform(0.01, 0.9, size=(n_per, 3)).astype(np.float32)
            v[:, axis] = g.uniform(1.0, 2.0, size=n_per)
            v[:, axis] *= -1.0 if negd else 1.0
            for k, a in enumerate(others):
                if signs >> k & 1:
                    v[:, a] *= -1.0
            d.append(v)
            o.append(g.uniform(-3, 9, size=(n_per, 3)).astype(np.float32))
            want.append(np.full(n_per, table * 4 + signs))
    return np.concatenate(o), np.concatenate(d), np.concatenate(want)


def _edge_rays(o, d):
    """Copies of rays with components 0.0, -0.0 and +-1e-13, an infinite
    direction or origin component, and NaN components."""
    o, d = o.copy(), d.copy()
    d[0::11, 0] = 0.0
    d[1::11, 1] = -0.0
    d[2::11, 2] = 1e-13
    d[3::11, 0] = -1e-13
    d[4::11, 1:] = 0.0
    d[5::11, 1] = np.inf
    d[6::11, 2] = -np.inf
    o[7::11, 0] = np.inf
    o[8::11, 2] = -np.inf
    d[9::11, 1] = np.nan
    o[10::22, 0] = np.nan
    return o, d


def test_ray_key_twin_classes_and_bits(small):
    _, walk, rays = small
    rows = walk.rows.numpy()
    assert ro.RAY_KEY_BITS == 24 and ro.RAY_DEAD_KEY == 2 ** 24 - 1
    o, d, want = _class_rays(3)
    live = np.ones(o.shape[0], bool)
    key = ro.ray_key(torch.tensor(o), torch.tensor(d), None, walk.rows)
    assert np.array_equal(key.numpy() >> 19, want)
    ref, _ = _key_np(o, d, live, rows)
    assert np.array_equal(key.numpy(), ref)
    # edge rays: the classes of their definition, slab rays 24, dead keys
    eo, ed = _edge_rays(*rays["bounce"])
    act = rays["active"]
    key = ro.ray_key(torch.tensor(eo), torch.tensor(ed), torch.tensor(act),
                     walk.rows).numpy()
    ref, cls = _key_np(eo, ed, act, rows)
    assert np.array_equal(key, ref)
    dead = ~act | np.isnan(eo).any(1) | np.isnan(ed).any(1)
    assert (key[dead] == ro.RAY_DEAD_KEY).all()
    assert (key[~dead] >= 0).all() and (key[~dead] < ro.RAY_DEAD_KEY).all()
    assert np.array_equal(key[~dead] >> 19, cls[~dead])
    slab = (np.isinf(ed).any(1) | np.isinf(eo).any(1)) & ~dead
    assert slab.sum() > 0 and (cls[slab] == 24).all()
    # -0.0 keys with the positive side, -1e-13 with the negative
    pair = torch.tensor([[1.0, -0.0, 0.5], [1.0, -1e-13, 0.5]])
    k = ro.ray_key(torch.zeros(2, 3), pair, None, walk.rows)
    assert (k >> 19).tolist() == [4, 5]


def _sorted_closest(walk, o, d, active):
    """The sorted ray query's twin: key, stable sort, the walk's plain
    version on the sorted rays, results scattered back to ray order."""
    key = ro.ray_key(o, d, active, walk.rows)
    _, perm = ro.radix_sort(key)
    pl = perm.long()
    sa = None if active is None else active[pl]
    prim, dist, bary = tix.intersect_closest_bvh(walk, o[pl], d[pl], sa)
    out = (torch.empty_like(prim), torch.empty_like(dist),
           torch.empty_like(bary))
    for t, s in zip(out, (prim, dist, bary)):
        t[pl] = s
    return out, key, perm


KINDS = ("camera", "bounce", "edge")


def _kind_rays(rays, kind):
    return _edge_rays(*rays["bounce"]) if kind == "edge" else rays[kind]


@pytest.fixture(scope="module")
def jax_hits(small):
    """The JAX walk's (prim_id, dist, bary) on every kind of rays, first
    with every lane active, then with `active`, all in one call: lanes
    are independent, and an all-true mask starts every lane at the root,
    as active=None does."""
    jtrv, _, rays = small
    o, d = (np.concatenate([_kind_rays(rays, k)[i] for k in KINDS] * 2)
            for i in (0, 1))
    r = rays["active"].shape[0]
    act = np.concatenate([np.ones(len(KINDS) * r, bool)]
                         + [rays["active"]] * len(KINDS))
    hit = jix.intersect_closest_bvh(jtrv, jnp.asarray(o), jnp.asarray(d),
                                    active=jnp.asarray(act))
    return {(k, masked): tuple(np.asarray(a)[j:j + r]
                               for a in (hit.prim_id, hit.dist, hit.bary))
            for masked in (False, True)
            for i, k in enumerate(KINDS)
            for j in [(len(KINDS) * masked + i) * r]}


@pytest.mark.parametrize("kind", KINDS)
def test_sorted_walk_equals_jax(small, jax_hits, kind):
    _, walk, rays = small
    o, d = _kind_rays(rays, kind)
    act = rays["active"]
    for active in (None, act):
        want = jax_hits[kind, active is not None]
        (prim, dist, bary), key, perm = _sorted_closest(
            walk, torch.tensor(o), torch.tensor(d),
            None if active is None else torch.tensor(active))
        for w, g in zip(want, (prim, dist, bary)):
            _same_bits(w, g)
        if kind != "edge":
            assert (prim.numpy() >= 0).mean() > 0.3
        # the sort groups each class in one run of slots
        cls = key.numpy()[perm.numpy()] >> 19
        assert (np.diff(cls) >= 0).all()
    if kind != "edge":
        return
    # the CPU entry point of the ray query is the same twin
    got = tk.closest_hit(_walk_only(walk), torch.tensor(o), torch.tensor(d),
                         torch.tensor(act))
    for g, s in zip(got, _sorted_closest(walk, torch.tensor(o),
                                         torch.tensor(d),
                                         torch.tensor(act))[0]):
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g, s.view(torch.int32)
                           if s.is_floating_point() else s)


def _walk_only(walk):
    return tix.TraversalArrays(tri_xform=None, planes=None, rows=None,
                               size=0, method="bvh", walk=walk)


@pytest.mark.parametrize("r, cap, sorts", [
    (tk.QUERY_SORT_MIN - 1, None, False),
    (tk.QUERY_SORT_MIN, None, True),
    (1000, 1000, True),
    (1001, 1000, False),
])
def test_query_sorts_between_its_limits(small, monkeypatch, r, cap, sorts):
    """`mt_closest_cuda` sorts a batch of QUERY_SORT_MIN to QUERY_SORT_MAX
    rays and walks any other in ray order (perm None). The key and sort
    take their twins on CPU tensors, so this runs the wrapper with its
    launch replaced; the cap is lowered to 1,000 rays for the last two
    cases."""
    _, walk, rays = small
    o, d = (torch.tensor(t[:r]) for t in rays["bounce"])
    act = torch.tensor(rays["active"][:r])
    seen = []
    monkeypatch.setattr(tk, "_closest_walk",
                        lambda trv, o, d, active, perm, stats:
                        seen.append(perm))
    if cap is not None:
        monkeypatch.setattr(tk, "QUERY_SORT_MAX", cap)
    assert tk.QUERY_SORT_MAX == (cap or ro.SORT_MAX_KEYS)
    tk.mt_closest_cuda(_walk_only(walk), o, d, act)
    (perm,) = seen
    if not sorts:
        assert perm is None
        return
    key = ro.ray_key_ref(o, d, act, walk.rows)
    assert torch.equal(perm, ro.radix_sort_ref(key)[1])


def test_permutation_covers_every_ray_once(small):
    _, walk, rays = small
    o, d = _edge_rays(*rays["bounce"])
    act = torch.tensor(rays["active"])
    key = ro.ray_key(torch.tensor(o), torch.tensor(d), act, walk.rows)
    vals, perm = ro.radix_sort(key, ro.RAY_SORT_PASSES)
    r = key.shape[0]
    assert perm.dtype == torch.int32
    assert torch.equal(torch.sort(perm.long()).values, torch.arange(r))
    assert torch.equal(vals, key[perm.long()])
    dead = int((key == ro.RAY_DEAD_KEY).sum())
    assert dead > int((~act).sum()) - 1 and dead > 0
    assert bool((vals[r - dead:] == ro.RAY_DEAD_KEY).all())
    assert bool((vals[:r - dead] < ro.RAY_DEAD_KEY).all())
    with pytest.raises(ValueError):
        ro.radix_sort(key, 2)
