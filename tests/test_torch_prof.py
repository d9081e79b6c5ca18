"""The stage probes (`restir_tpu_torch.prof`) and their kernels' plain
twins on the CPU, and the exact walks' twins on NaN rays.

- every probe module runs with device="cpu" at a tiny size and prints
  its rows;
- the radix sort: its twin is torch.sort(stable=True), and the numpy
  rendition of the kernels' one-sweep passes (`_sort_plan`: digit
  counts, per-round ranks among equal digits, look-back prefixes) gives
  the same permutation on random keys with ties;
- the coherence key's twin against a numpy rendition;
- the any hit's twins (FP32 dots; TF32 pieces for the tensor-core
  forms) against each other and against the JAX package's occlusion test
  (`restir_tpu.ops.intersect_bf`) on headline-scene segments at 128x32,
  within the primitive gate (mismatch <= 0.2 %): the FP32 and 6xTF32
  forms hold it, 3xTF32 (22 bits an operand) does not on segments that
  end on a surface;
- the gather and chain twins against numpy, bit for bit, and the chain
  kernels' factor table against numpy's;
- `_build`'s named variants leave the main library's digest alone;
- the lockstep walks (B13 / B14's twins) on rays with NaN components
  against the JAX walks: every box missed, as the kernels now do.
"""

import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _sort_plan import sort_plan

from restir_tpu.ops import intersect as jix
from restir_tpu.ops import intersect_bf as jbf
from restir_tpu.scene import scene_data as jsd
from restir_tpu.scene.procedural import many_light_scene as jax_scene
from restir_tpu_torch import convert
from restir_tpu_torch.config import RenderConfig, TracerType
from restir_tpu_torch.models import gbuffer as general_gb
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops import intersect_bf, lights
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.ops.kernels import _build
from restir_tpu_torch.ops.kernels import intersect as hits
from restir_tpu_torch.prof import PROBES
from restir_tpu_torch.prof import kernels as pk
from restir_tpu_torch.scene.procedural import many_light_scene
from restir_tpu_torch.utils import rng


@pytest.mark.parametrize("probe", PROBES)
def test_probe_runs_on_cpu(probe, capsys):
    import importlib

    mod = importlib.import_module(f"restir_tpu_torch.prof.{probe}")
    rows = mod.run(device="cpu", small=True)
    out = capsys.readouterr().out
    assert rows, out
    short = probe[len("prof_"):]
    for name, variant, ms in rows:
        assert name == short and np.isfinite(ms) and ms >= 0.0
        assert f"probe {short} {variant}: " in out


def test_main_runs_a_probe_on_cpu(capsys):
    from restir_tpu_torch.prof.__main__ import main

    assert main(["v3", "prof_gather", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "probe v3 soa: " in out
    assert "probe gather K1024.ldg: " in out
    with pytest.raises(SystemExit):
        main(["nope", "--cpu"])


def test_radix_sort_twin_is_a_stable_sort():
    g = np.random.default_rng(5)
    for r, hi in ((1000, 2 ** 30), (777, 37), (256, 1)):
        keys = g.integers(0, hi, size=r).astype(np.int32)
        keys[::11] = pk.DEAD_KEY
        want = np.argsort(keys, kind="stable")
        vals, perm = pk.radix_sort(torch.tensor(keys))
        assert perm.dtype == torch.int32
        assert np.array_equal(perm.numpy(), want)
        assert np.array_equal(vals.numpy(), keys[want])
        kv, pv = sort_plan(keys, pk.SORT_BITS)
        assert np.array_equal(pv, want) and np.array_equal(kv, keys[want])


def test_coherence_key_twin_matches_numpy():
    g = np.random.default_rng(6)
    r = 3000
    x = g.uniform(-2, 5, size=(r, 3)).astype(np.float32)
    y = g.uniform(-2, 5, size=(r, 3)).astype(np.float32)
    x[:3] = [[-9, 0, 0], [9, 9, 9], [np.nan, 1, 1]]  # clamped, NaN -> 0
    live = g.random(r) < 0.8
    lo, hi = (-1.0, -1.5, 0.0), (4.0, 4.5, 3.0)
    lo32 = np.array(lo, np.float32)
    ext = np.array(hi, np.float32) - lo32

    def cell(p, bits):
        with np.errstate(invalid="ignore"):
            u = (p - lo32) / ext
        u = np.where(u >= 0, u, np.float32(0)).astype(np.float32)
        u = np.minimum(u, np.float32(0.99999994))
        return (u * np.float32(1 << bits)).astype(np.int64)

    def morton(p, bits):
        q = cell(p, bits)
        code = np.zeros(p.shape[0], np.int64)
        for b in range(bits):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        return code

    s = y - x
    m = np.maximum(np.abs(s).max(axis=1), np.float32(1e-30))
    direction = np.zeros(r, np.int64)
    for a in range(3):
        with np.errstate(invalid="ignore"):
            u = ((s[:, a] / m + np.float32(1)) * np.float32(0.5))
        u = np.minimum(np.where(u >= 0, u, np.float32(0)),
                       np.float32(0.99999994)).astype(np.float32)
        direction = (direction << 4) | (u * np.float32(16)).astype(np.int64)
    want = {"origin": morton(x, 10),
            "target_origin": (morton(y, 3) << 21) | morton(x, 7),
            "direction_origin": (direction << 18) | morton(x, 6)}
    for order in pk.KEY_ORDERS:
        got = pk.coherence_key(torch.tensor(x), torch.tensor(y),
                               torch.tensor(live), lo, hi, order).numpy()
        exp = np.where(live, want[order], pk.DEAD_KEY)
        assert np.array_equal(got[3:], exp[3:]), order
        assert got.max() < 2 ** 31 and (got[live] < 2 ** 30).all()


def _headline_segments(w=128, h=32):
    """Segments from the camera hits of the headline scene to light
    points at w x h (float32 numpy), with the scene's tri_xform."""
    arrays, camkw = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.PT_DIRECT)
    trv = tix.traversal_arrays(scene, "brute")
    pix, o, d = general_gb.primary_rays(cam, cfg, 1, rng.SALT_CAMERA, "cpu")
    prim, _, _, pos, _, _, _ = hits.primary_hit(
        trv, scene.prim_attr, scene.mat_attr, o.contiguous(),
        d.contiguous())
    l1, l2, l3, l4 = rng.uniform4(pix, 1, 1, rng.SALT_PT)
    ls = lights.sample_direct_light_no_visibility(scene, pos, l1, l2, l3, l4,
                                                  has_env=False)
    keep = (prim >= 0) & (ls.pdf > 0)
    target = pos + ls.wi * ls.dist[:, None]
    return (pos[keep].contiguous(), target[keep].contiguous(),
            trv.tri_xform)


def test_anyhit_twins_match_jax_occlusion():
    x, y, xform = _headline_segments()
    o, d, limit = intersect_bf.occlusion_ray(x, y)
    r = o.shape[0]
    rays = torch.cat([o.T, d.T, limit[None], torch.zeros(1, r)]).contiguous()
    planes = pk.plane_rows(xform, 512)
    fma = pk.anyhit(rays, planes, "fma")
    mma3 = pk.anyhit(rays, planes, "mma3")
    mma6 = pk.anyhit(rays, planes, "mma6")
    want = np.asarray(jbf.test_occlusion_bf(jnp.asarray(xform.numpy()),
                                            jnp.asarray(x.numpy()),
                                            jnp.asarray(y.numpy())))
    assert 0.05 < want.mean() < 0.95  # some segments blocked, some not
    gate = 0.002  # the reference's primitive gate
    assert (fma.numpy() != want).mean() <= gate
    assert (mma6.numpy() != want).mean() <= gate
    assert (mma6 != fma).float().mean() <= gate
    # 3xTF32 drops below the gate's precision here (measured 0.31 %)
    assert (mma3.numpy() != want).mean() > gate
    # each piece is a TF32 value; three hold every mantissa bit
    pieces = pk.tf32_split(planes)
    for piece in pieces:
        assert not bool((piece.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(pieces[0] + pieces[1] + pieces[2], planes)


def test_gather_and_chain_twins_match_numpy():
    g = np.random.default_rng(8)
    for k in (1024, 8192):
        table = g.normal(size=k).astype(np.float32)
        idx = pk.gather_index(5000, k, "cpu")
        assert np.array_equal(idx.numpy(), (np.arange(5000) * 7919) % k)
        for where in pk.GATHER_WHERE:
            got = pk.table_gather(torch.tensor(table), idx, where).numpy()
            assert np.array_equal(got, table[idx.numpy()])
    src = g.normal(size=(9, 700)).astype(np.float32)
    perm = g.permutation(700).astype(np.int32)
    assert np.array_equal(
        pk.gather_cols(torch.tensor(src), torch.tensor(perm)).numpy(),
        src[:, perm])
    assert np.array_equal(pk.copy_pack(torch.tensor(src)).numpy(), src)

    pack = g.uniform(0, 1, size=(8, 600)).astype(np.float32)
    a, b, m = pack[0:3].copy(), pack[3:6], pack[6] > 0.5
    for i in range(90):
        c = np.float32(0.5 + i * 1e-3)
        a = np.where(m, a * c + b, a).astype(np.float32)
    for layout in pk.CHAIN_LAYOUTS:
        got = pk.chain(torch.tensor(pack), layout).numpy()
        assert np.array_equal(got, a), layout
    with pytest.raises(ValueError):
        pk.chain(torch.tensor(pack), "nope")


def test_chain_factors_equal_numpy():
    """The chain kernels' factors (`csrc/prof/chain_factors.cuh`, hex
    floats) are numpy's float32(0.5 + i * 1e-3) and the twin's, bit for
    bit."""
    src = (_build.PROBE_DIR / "chain_factors.cuh").read_text()
    body = src.split("constexpr float c[kChainRounds] = {")[1].split("};")[0]
    lits = re.findall(r"(0x[0-9a-f.]+p-?[0-9]+)f", body)
    got = np.array([float.fromhex(x) for x in lits], dtype=np.float64)
    assert len(got) == pk.CHAIN_ROUNDS == 90
    # each literal is a float32 as written (no rounding on the way in)
    assert np.array_equal(got.astype(np.float32).astype(np.float64), got)
    want = np.array([np.float32(0.5 + i * 1e-3) for i in range(90)])
    assert np.array_equal(got.astype(np.float32).view(np.uint32),
                          want.view(np.uint32))
    assert np.array_equal(pk.CHAIN_FACTORS.view(np.uint32),
                          want.view(np.uint32))


def test_variant_builds_leave_the_main_digest():
    main = _build._digest()
    names = [f.name for f in _build._sources()]
    assert not any(f.parent.name == "prof" for f in _build._sources())
    digests = {n: _build.variant_digest(n) for n in _build.VARIANTS}
    assert _build._digest() == main
    assert len(set(digests.values())) == len(digests)
    assert main not in digests.values()
    for name, (srcs, flags) in _build.VARIANTS.items():
        assert all(f.startswith("-DPROBE_") for f in flags), name
        for s in srcs:
            path = _build.SRC_DIR / s
            assert path.exists(), s
            assert s.startswith("prof/") or path.name in names
    # every stub build names a PROBE block of its source
    for src, macro in (("gbuffer_bvh.cu", "PROBE_GBUF"),
                       ("reuse_bvh.cu", "PROBE_WALK"),
                       ("ris_cdf.cu", "PROBE_WALK")):
        assert f"defined({macro})" in (_build.SRC_DIR / src).read_text()


@pytest.fixture(scope="module")
def nan_world():
    scene, camkw = jax_scene(n_lights=8, n_blocks=4, bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtrv = jsd.traversal_arrays(scene, "bvh")
    walk = tix.traversal_arrays(tscene, "bvh").walk
    g = np.random.default_rng(11)
    r = 96
    o = np.tile(np.array([[0.0, 4.0, 12.0]], np.float32), (r, 1))
    o += g.normal(scale=0.5, size=(r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[0::6, 0] = np.nan
    o[1::6, 2] = np.nan
    d[2::6, 1] = np.nan
    d[3::6] = np.nan
    return jtrv, walk, o, d


def test_walk_twins_on_nan_rays_match_jax(nan_world):
    """A ray with a NaN origin or direction component misses every box in
    the JAX walk (jnp.minimum keeps the NaN): no hit, no descended node,
    not occluded; the twins (and B13 / B14, which test it at the ray's
    start) do the same, lane for lane with the finite rays beside."""
    jtrv, walk, o, d = nan_world
    want = jix.intersect_closest_bvh(jtrv, jnp.asarray(o), jnp.asarray(d))
    prim, dist, bary = tix.intersect_closest_bvh(walk, torch.tensor(o),
                                                 torch.tensor(d))
    assert np.array_equal(np.asarray(want.prim_id), prim.numpy())
    assert np.array_equal(np.asarray(want.dist), dist.numpy())
    nan = np.isnan(o).any(1) | np.isnan(d).any(1)
    assert (prim.numpy()[nan] == -1).all() and np.isinf(dist.numpy()[nan]).all()
    assert (prim.numpy()[~nan] >= 0).any()
    vis = tix.intersect_visualize(walk, torch.tensor(o), torch.tensor(d))
    assert np.array_equal(np.asarray(jix.intersect_visualize(
        jtrv, jnp.asarray(o), jnp.asarray(d))), vis.numpy())
    assert (vis.numpy()[nan] == 0).all() and (vis.numpy()[~nan] > 0).all()
    y = o + 20.0 * np.nan_to_num(d)
    occ = tix.test_occlusion_bvh(walk, torch.tensor(o), torch.tensor(y))
    assert np.array_equal(np.asarray(jix.test_occlusion_bvh(
        jtrv, jnp.asarray(o), jnp.asarray(y))), occ.numpy())
    assert not occ.numpy()[np.isnan(o).any(1)].any()
    # the root's miss index ends every table: a missed root ends the walk
    size = walk.size
    assert all(int(walk.miss_flat[t * size]) == size for t in range(6))
