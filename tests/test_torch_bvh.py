"""The port's MTBVH: its builder against the JAX package's, and the
lockstep walks (the CUDA traversal's twins) against brute force.

- `restir_tpu_torch.scene.bvh.build_bvh` equals
  `restir_tpu.scene.bvh.build_bvh(impl="numpy")` EXACTLY (bounds and all
  six tables) on many_light_scene(16, 120) and on the Cornell box;
- the table index equals the JAX `get_mtbvh_id`, ties included;
- the padded device boxes contain the exact ones;
- the lockstep closest-hit walk (`ops/kernels/bvh_walk.py`, which mirrors
  `csrc/bvh.cuh`) returns the brute-force `fused_di.closest_brute` hit on
  every primary ray of a 128x32 frame, and the any-hit walk the brute
  `occluded_brute` answer on every shadow ray of it;
- walking the opposite table finds the same hits with more box tests, so
  the table choice is what makes the walk cheap.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.scene import bvh as jbvh
from restir_tpu.scene.loader import parse_scene_file
from restir_tpu.scene.procedural import many_light_scene as j_scene
from restir_tpu_torch import convert
from restir_tpu_torch.ops.camera import make_camera, pack_camera
from restir_tpu_torch.ops.kernels import bvh_walk, fused_di, gbuffer, tables
from restir_tpu_torch.scene import bvh as tbvh
from restir_tpu_torch.scene.procedural import many_light_scene

W, H = 128, 32
R = W * H
SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def _verts(name):
    if name == "cornell":
        sf = parse_scene_file(os.path.join(SCENES, "cornell.txt"))
        return np.asarray(sf.build(bvh_impl="numpy").verts).reshape(-1, 3)
    return np.asarray(j_scene(16, 120, bvh_impl="numpy")[0].verts).reshape(
        -1, 3)


@pytest.fixture(scope="module", params=["many_light_16_120", "cornell"])
def built(request):
    v = _verts(request.param)
    return jbvh.build_bvh(v, impl="numpy"), tbvh.build_bvh(v)


@pytest.mark.parametrize("field", jbvh.BVH._fields)
def test_bvh_equals_jax_numpy_builder(built, field):
    want, got = (getattr(b, field) for b in built)
    if field == "size":
        assert got == want
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_table_index_equals_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    ties = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 0],
                     [-1, -1, 0], [0, -1, -1], [-1, 0, 1], [-0.0, 0, 0],
                     [0, -0.0, 0], [0, 0, -0.0], [2, -2, 2]], np.float32)
    d = np.concatenate([d, ties, -ties])
    want = np.asarray(jbvh.get_mtbvh_id(jnp.asarray(d)))
    t = torch.tensor(d)
    got = tbvh.get_mtbvh_id(t[:, 0], t[:, 1], t[:, 2]).numpy()
    assert np.array_equal(got, want)


def test_padded_boxes_contain_exact(built):
    b = built[1]
    pad = tables.padded_bounds(b.bounds_lo, b.bounds_hi)
    assert (pad[:, 0:3] < b.bounds_lo).all()
    assert (pad[:, 4:7] > b.bounds_hi).all()
    scale = max(np.abs(b.bounds_lo).max(), np.abs(b.bounds_hi).max())
    assert (b.bounds_lo - pad[:, 0:3]).max() <= 2 * tables.BOX_PAD_REL * scale


@pytest.fixture(scope="module")
def frame():
    """The port's large scene, its primary rays (AA jitter on) and the
    brute-force twin's hits and shadow rays."""
    arrays, camkw = many_light_scene(16, 120)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cv = pack_camera(make_camera(**camkw))
    gb = gbuffer.gbuffer_ref(cv, cv, 5, scene.bvh, width=W, height=H)
    o = tuple(cv[i].expand(R) for i in range(3))
    d = tuple(gb[fused_di.G_DIR + i] for i in range(3))
    pix = torch.arange(R)
    _, wi, dist, _ = fused_di.ris_pixels(gb, pix, 5, scene.tables, k=4,
                                         single_sided=True, has_met=True)
    return scene, gb, o, d, wi, dist


def test_closest_walk_equals_brute_force(frame):
    scene, _, o, d, _, _ = frame
    want = fused_di.closest_brute(scene.bvh.planes, o, d)
    dist, prim, u, v, boxes, tris = bvh_walk.closest_walk(scene.bvh, o, d)
    assert (want[1] >= 0).float().mean() > 0.9  # the frame hits geometry
    for name, a, b in zip(("dist", "prim", "u", "v"), want,
                          (dist, prim, u, v)):
        assert torch.equal(a, b), name
    # the walk tests a small part of the 1482 triangles
    assert float(tris.float().mean()) < 0.05 * scene.num_tris
    assert (boxes >= tris).all()


def test_occluded_walk_equals_brute_force(frame):
    scene, gb, _, _, wi, dist = frame
    o = tuple(gb[fused_di.G_POS + c] + wi[c] * 1e-5 for c in range(3))
    limit = dist * (1.0 - 1e-3) - 1e-4
    self_prim = gb[fused_di.G_PRIM].to(torch.int32)
    want = fused_di.occluded_brute(scene.bvh.planes, o, tuple(wi), limit,
                                   self_prim)
    got, boxes, tris = bvh_walk.occluded_walk(scene.bvh, o, tuple(wi), limit,
                                              self_prim)
    assert want.any() and not want.all()
    assert torch.equal(got, want)
    assert (boxes[limit <= 0.0] == 0).all()  # dead lanes walk nothing


def test_opposite_table_costs_more(frame, monkeypatch):
    scene, _, o, d, _, _ = frame
    dist, prim, _, _, boxes, _ = bvh_walk.closest_walk(scene.bvh, o, d)
    flip = {0: 1, 1: 0, 2: 3, 3: 2, 4: 5, 5: 4}

    def opposite(dx, dy, dz):
        t = tbvh.get_mtbvh_id(dx, dy, dz)
        return torch.tensor([flip[int(x)] for x in t], dtype=torch.int32)

    monkeypatch.setattr(bvh_walk, "get_mtbvh_id", opposite)
    dist2, prim2, _, _, boxes2, _ = bvh_walk.closest_walk(scene.bvh, o, d)
    assert torch.equal(prim, prim2) and torch.equal(dist, dist2)
    assert float(boxes2.float().mean()) > 1.05 * float(boxes.float().mean())
