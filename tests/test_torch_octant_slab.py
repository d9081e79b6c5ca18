"""The slab test chosen by the ray's signs (B14's walk, csrc/bvh.cuh) on
the CPU: a float32 mirror of the kernel's two forms.

B14 walks each ray with the box's near and far planes picked once from
the signs of the ray's inverse direction (`safe_inv`), which takes 4
min / max per box test in place of the min / max slab's 10. Here a
torch mirror of both forms (`torch.fmin` / `torch.fmax` drop a NaN
operand as CUDA's `fminf` / `fmaxf` do) must give the same box hit and
the same entry distance on every (ray, node box) pair of the exact
node rows of `many_light_scene` and of a scene of axis-aligned quads
(boxes flat on an axis), for seeded rays with direction components
0.0, -0.0, +-1e-13, a NaN axis, huge and infinite values, origins on
the boxes' planes and at infinity. Rays with a zero inverse component
or an infinite origin take the min / max form in the kernel too, as
here. The walk's tables refuse a node box with lo > hi (or NaN), on
which the sign argument would not hold.
"""

import numpy as np
import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.ops.kernels import tables
from restir_tpu_torch.scene.bvh import build_bvh
from restir_tpu_torch.scene.procedural import many_light_scene

F32 = torch.float32


def safe_inv(d):
    """bvh.cuh safe_inv: 1 / d with |d| clamped to 1e-12."""
    tiny = torch.tensor(1e-12, dtype=F32)
    return 1.0 / torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny),
                             d)


def minmax_slab(o, inv, lo, hi):
    """bvh.cuh `slab`: (hit, t_near) of rays [R, 3] on boxes [N, 3]."""
    t1 = (lo[None] - o[:, None]) * inv[:, None]
    t2 = (hi[None] - o[:, None]) * inv[:, None]
    lo_t, hi_t = torch.fmin(t1, t2), torch.fmax(t1, t2)
    t_near = torch.fmax(torch.fmax(lo_t[..., 0], lo_t[..., 1]), lo_t[..., 2])
    t_far = torch.fmin(torch.fmin(hi_t[..., 0], hi_t[..., 1]), hi_t[..., 2])
    return (t_far >= 0) & (t_far >= t_near), t_near


def octant_slab(o, inv, lo, hi):
    """bvh.cuh `octant_slab`: the near plane is lo where the inverse
    direction is positive and hi where it is negative (its sign bit)."""
    neg = torch.signbit(inv)[:, None]
    near = torch.where(neg, hi[None], lo[None])
    far = torch.where(neg, lo[None], hi[None])
    tn = (near - o[:, None]) * inv[:, None]
    tf = (far - o[:, None]) * inv[:, None]
    t_near = torch.fmax(torch.fmax(tn[..., 0], tn[..., 1]), tn[..., 2])
    t_far = torch.fmin(torch.fmin(tf[..., 0], tf[..., 1]), tf[..., 2])
    return (t_far >= 0) & (t_far >= t_near), t_near


def min_max_form(o, inv):
    """The rays the kernel walks with the min / max slab: a zero inverse
    component (an infinite direction) or an infinite origin."""
    return (inv == 0).any(1) | torch.isinf(o).any(1)


def seeded_rays(lo, hi, n, seed):
    """n rays [n, 3] (origins, directions) around the boxes lo / hi, with
    the edge-case components of the module docstring."""
    g = np.random.default_rng(seed)
    span_lo, span_hi = lo.min(0), hi.max(0)
    pad = 0.25 * (span_hi - span_lo) + 1.0
    o = g.uniform(span_lo - pad, span_hi + pad, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    # origins exactly on box planes
    pick = g.integers(0, lo.shape[0], n)
    axis = g.integers(0, 3, n)
    on = g.random(n) < 0.3
    plane = np.where(g.random(n) < 0.5, lo[pick, axis], hi[pick, axis])
    o[on, axis[on]] = plane[on]
    special = np.array([0.0, -0.0, 1e-13, -1e-13, 1e30, -1e30, 3e38,
                        1e-40, np.nan, np.inf, -np.inf], np.float32)
    k = g.random((n, 3)) < 0.2
    d[k] = special[g.integers(0, special.size, int(k.sum()))]
    # a NaN on one axis only, and axis-parallel rays (two zeros)
    d[0:8, :] = g.normal(size=(8, 3))
    d[0:8, g.integers(0, 3, 8)] = np.nan
    d[8:16, 1:] = np.array([0.0, -0.0], np.float32)
    # huge and infinite origins
    o[16:24] = g.choice(np.array([1e30, -1e30, np.inf, -np.inf],
                                 np.float32), (8, 3))
    return torch.from_numpy(o), torch.from_numpy(d)


def _quads():
    """Axis-aligned quads (two triangles each): a floor, two walls and
    a shelf, so many node boxes are flat on one axis."""
    quads = [
        [(-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)],
        [(-4, 0, -4), (-4, 5, -4), (-4, 5, 4), (-4, 0, 4)],
        [(-4, 0, -4), (4, 0, -4), (4, 5, -4), (-4, 5, -4)],
        [(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)],
        [(2, 0.5, 2), (3, 0.5, 2), (3, 0.5, 3), (2, 0.5, 3)],
    ]
    tris = []
    for a, b, c, e in quads:
        tris += [(a, b, c), (a, c, e)]
    return np.asarray(tris, np.float32)


def _boxes(name):
    if name == "many_light_scene":
        arrays, _ = many_light_scene(8, 4)
        scene = convert.scene_from_numpy(arrays, "cpu")
        w = scene.walk.get()
        return w.rows[:, 0:3].clone(), w.rows[:, 4:7].clone()
    bvh = build_bvh(_quads().reshape(-1, 3), impl="numpy")
    rows = tables.exact_node_rows({
        "bounds_lo": bvh.bounds_lo, "bounds_hi": bvh.bounds_hi,
        "bvh_prim": bvh.prim_id, "bvh_box": bvh.box_id,
        "bvh_miss": bvh.miss})
    rows = torch.from_numpy(rows)
    return rows[:, 0:3].clone(), rows[:, 4:7].clone()


@pytest.mark.parametrize("scene", ["many_light_scene", "axis_aligned_quads"])
@pytest.mark.parametrize("seed", [0, 1])
def test_octant_slab_equals_min_max_slab(scene, seed):
    lo, hi = _boxes(scene)
    flat = (lo == hi).any(1)
    if scene == "axis_aligned_quads":
        assert bool(flat.any())  # the boxes this scene is here for
    o, d = seeded_rays(lo.numpy(), hi.numpy(), 256, seed)
    inv = safe_inv(d)
    hit_p, tn_p = minmax_slab(o, inv, lo, hi)
    hit_o, tn_o = octant_slab(o, inv, lo, hi)
    generic = min_max_form(o, inv)
    hit_o = torch.where(generic[:, None], hit_p, hit_o)
    tn_o = torch.where(generic[:, None], tn_p, tn_o)
    assert torch.equal(hit_o, hit_p)
    # the same entry distance wherever a box is hit (a zero's sign may
    # differ; every use of t_near is a comparison)
    same_t = (tn_o == tn_p) | (torch.isnan(tn_o) & torch.isnan(tn_p))
    assert bool(same_t[hit_p].all())
    # so every descend decision (hit and t_near < best) is the same
    for best in (float("inf"), 3.0, 0.5, 1e-3, 0.0):
        assert torch.equal(hit_o & (tn_o < best), hit_p & (tn_p < best))
    # the sign form is the one nearly every ray takes, and rays hit boxes
    assert float(generic.float().mean()) < 0.5
    assert bool(hit_p[~generic].any())


def test_octant_slab_differs_only_where_the_kernel_keeps_min_max():
    """Without the min / max form for infinite directions and origins the
    sign form would part from it: an infinite origin on a box with an
    infinite plane, a zero inverse on a plane an infinite way off."""
    lo = torch.tensor([[-1.0, -1.0, -1.0]], dtype=F32)
    hi = torch.tensor([[1.0, 1.0, float("inf")]], dtype=F32)
    o = torch.tensor([[0.0, 0.0, float("inf")], [-5.0, 0.0, 0.0]],
                     dtype=F32)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.5, 0.0, float("inf")]], dtype=F32)
    inv = safe_inv(d)
    assert bool(min_max_form(o, inv).all())
    hit_p, _ = minmax_slab(o, inv, lo, hi)
    hit_o, _ = octant_slab(o, inv, lo, hi)
    assert not bool((hit_p == hit_o).any())


@pytest.mark.parametrize("bad", ["lo_above_hi", "nan"])
def test_walk_tables_refuse_a_box_with_lo_above_hi(bad):
    arrays, _ = many_light_scene(4, 2)
    lo = np.array(arrays.bounds_lo, np.float32)
    hi = np.array(arrays.bounds_hi, np.float32)
    row = lo.shape[0] // 2
    if bad == "nan":
        lo[row, 1] = np.nan
    else:
        lo[row, 2] = hi[row, 2] + 1.0
    a = {"bounds_lo": lo, "bounds_hi": hi, "bvh_prim": arrays.bvh_prim,
         "bvh_box": arrays.bvh_box, "bvh_miss": arrays.bvh_miss}
    with pytest.raises(ValueError, match=f"node box {row}"):
        tables.exact_node_rows(a)
    with pytest.raises(ValueError, match=f"node box {row}"):
        tables.build_walk_tables({**a, "verts": arrays.verts},
                                 torch.from_numpy(np.asarray(arrays.verts)))
    # the builder's own boxes pass
    assert tables.exact_node_rows({**a, "bounds_lo": np.array(
        arrays.bounds_lo, np.float32)}).shape[0] == 6 * lo.shape[0]
