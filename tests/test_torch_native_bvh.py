"""The port's native C++ BVH builder (`restir_tpu_torch.native`) against
its numpy builder and the JAX package's, on the CPU.

- `tests/test_native_bvh.py`'s random cases and the degenerate one (16
  identical triangles): the native tree equals the port's numpy tree and
  `restir_tpu.scene.bvh._build_bvh_numpy`'s bit for bit;
- the procedural scenes, whose axis-aligned boxes tie in SAH cost: the
  same (the JAX package's own native builder sums the SAH areas in
  float64 and splits some of these ties the other way);
- the MTBVH walk over a native tree returns the brute force's hits;
- `build_bvh`'s "auto" takes the native builder, falls back to numpy
  with one warning only where g++ is missing, and "native" raises there.
"""

import warnings

import numpy as np
import pytest
import torch

from restir_tpu.scene.bvh import _build_bvh_numpy as jax_numpy_bvh
from restir_tpu_torch.native import bvh_native
from restir_tpu_torch.ops import intersect as ix
from restir_tpu_torch.ops.kernels.tables import build_walk_tables
from restir_tpu_torch.scene import bvh as tbvh
from restir_tpu_torch.scene import procedural


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n, 1, 3))
    return (centers + rng.normal(0, 0.5, (n, 3, 3))).astype(
        np.float32).reshape(-1, 3)


def _degenerate():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    return np.tile(tri, (16, 1))  # 16 identical triangles


def _assert_same_tree(a, b):
    assert a.size == b.size
    for field in ("bounds_lo", "bounds_hi", "prim_id", "box_id", "miss"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert np.array_equal(x, y), field


CASES = [(1, 0), (2, 1), (33, 2), (500, 3), (2000, 4)]


@pytest.mark.parametrize("verts", [_random_tris(n, s) for n, s in CASES]
                         + [_degenerate()],
                         ids=[f"n{n}-seed{s}" for n, s in CASES]
                         + ["degenerate"])
def test_native_matches_numpy(verts):
    native = bvh_native.build_bvh_native(verts)
    _assert_same_tree(tbvh.build_bvh(verts, impl="numpy"), native)
    _assert_same_tree(jax_numpy_bvh(verts), native)


@pytest.mark.parametrize("scene", ["many_light_120", "cornell", "env",
                                   "textured"])
def test_native_matches_numpy_on_scenes(scene):
    build = {
        "many_light_120": lambda: procedural.many_light_scene(
            16, 120, bvh_impl="numpy"),
        "cornell": lambda: procedural.cornell_box(bvh_impl="numpy"),
        "env": lambda: procedural.env_scene(bvh_impl="numpy"),
        "textured": lambda: procedural.textured_scene(
            bvh_impl="numpy", aux_maps=True),
    }[scene]
    arrays, _ = build()
    verts = arrays.verts.reshape(-1, 3)
    native = tbvh.build_bvh(verts, impl="native")
    _assert_same_tree(tbvh.build_bvh(verts, impl="numpy"), native)
    assert np.array_equal(native.prim_id.reshape(-1), arrays.bvh_prim)


def test_native_traversal_correct():
    """The MTBVH walk over a native tree gives the brute force's hits."""
    verts = _random_tris(200, 7)
    bvh = bvh_native.build_bvh_native(verts)
    arrays = {"verts": verts.reshape(-1, 3, 3),
              "bounds_lo": bvh.bounds_lo, "bounds_hi": bvh.bounds_hi,
              "bvh_prim": bvh.prim_id, "bvh_box": bvh.box_id,
              "bvh_miss": bvh.miss}
    tv = torch.from_numpy(verts.reshape(-1, 3, 3))
    walk = build_walk_tables(arrays, tv)
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-6, 6, (256, 3)).astype(np.float32))
    d0 = rng.standard_normal((256, 3)).astype(np.float32)
    d = torch.from_numpy(d0 / np.linalg.norm(d0, axis=-1, keepdims=True))
    prim, dist, _ = ix.intersect_closest_bvh(walk, o, d)
    ref = ix.brute_force_closest(tv, o, d)
    hit_g = prim.numpy() >= 0
    hit_r = ref.prim_id.numpy() >= 0
    assert hit_r.sum() >= 20  # the rays do hit
    assert (hit_g == hit_r).mean() > 0.995
    both = hit_g & hit_r
    assert np.allclose(dist.numpy()[both], ref.dist.numpy()[both],
                       rtol=1e-4)


def test_auto_falls_back_only_without_gxx(monkeypatch):
    verts = _random_tris(33, 2)
    want = tbvh.build_bvh(verts, impl="numpy")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # "auto" with g++: no warning
        _assert_same_tree(want, tbvh.build_bvh(verts))

    monkeypatch.setattr(bvh_native, "_lib", None)
    monkeypatch.setattr(bvh_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(bvh_native, "library_path",
                        lambda: bvh_native.BUILD_DIR / "libbvh_missing.so")
    monkeypatch.setattr(tbvh, "_warned_numpy", False)
    with pytest.raises(bvh_native.ToolchainMissing):
        tbvh.build_bvh(verts, impl="native")
    with pytest.warns(UserWarning, match="g\\+\\+ not found"):
        _assert_same_tree(want, tbvh.build_bvh(verts))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once
        _assert_same_tree(want, tbvh.build_bvh(verts))
    with pytest.raises(ValueError):
        tbvh.build_bvh(verts, impl="fast")
