"""Row-band arguments of the kernels' twins: B6 (`gbuffer_ref`), B7 + B1b
(`reuse_ref`), the temporal merge (`temporal_pixels`), B2
(`spatial_offsets` + `spatial_shade_ref`) and B5 (`svgf_temporal_ref`).

- Each band twin equals the matching pixels of its whole-frame twin bit
  for bit, on every band of 128x32 in 2 bands, 256x32 in 4 (r_loc 2048,
  the single device's temporal window) and 384x16 in 3 (bands that
  start mid-row). Frame 1 has live temporal history (a static camera, as
  the multi-device step's tests use).
- Each band twin against the JAX wrapper that takes the same band
  arguments (`gbuffer_pack_pallas(pix0=, xy=)`, `reuse_pallas(pix0=,
  prev_base=, window=)`, `spatial_shade_pallas(pix0=, halo=, r_total=)`,
  `svgf_temporal_pallas(prev_base=, window=)`, in interpret mode) on
  band 1 of 2 at 128x16, under the pack gates of
  `restir_tpu_torch.parity`; B2's offset table equals the JAX wrapper's
  exactly.
Inputs come from numpy seeds and the converted JAX scene.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.ops.camera import make_camera
from restir_tpu.ops.pallas import fused_di as fk
from restir_tpu.scene.procedural import many_light_scene
from restir_tpu_torch import convert, parity
from restir_tpu_torch.config import RenderConfig
from restir_tpu_torch.ops.kernels import fused_di as tk
from restir_tpu_torch.ops.kernels import gbuffer, reuse, spatial, svgf
from restir_tpu_torch.parallel.fused_sharding import band_layout, haloed

SIZES = {"128x32/2": (128, 32, 2), "256x32/4": (256, 32, 4),
         "384x16/3": (384, 16, 3)}
KERNELS = ("gbuffer", "reuse", "temporal", "spatial", "svgf")
LOOPER = 1
N_NB, RADIUS = 5, 5.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its thousands of small torch
    ops otherwise spend most of their time in the thread pool when
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    scene, camkw = many_light_scene(n_lights=16, n_blocks=6,
                                    bvh_impl="numpy")
    tscene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    return scene, tscene, make_camera(**camkw)


def _cam(cam, w, h):
    return torch.tensor(np.asarray(fk.pack_camera(cam, w, h)))


def _whole(tscene, cv, w, h):
    """Frames 0 and 1 of the whole-frame twins: (gb1, pt0, pt1)."""
    r = w * h
    gb0 = gbuffer.gbuffer_ref(cv, cv, 0, tscene.bvh, width=w, height=h)
    pt0 = reuse.reuse_ref(gb0, torch.zeros(tk.PT_CH, r), 0, tscene.tables)
    gb1 = gbuffer.gbuffer_ref(cv, cv, LOOPER, tscene.bvh, width=w, height=h)
    pt1 = reuse.reuse_ref(gb1, pt0, LOOPER, tscene.tables)
    return gb1, pt0, pt1


_FRAMES = {}


@pytest.fixture
def frames(world):
    def get(size):
        if size not in _FRAMES:
            w, h, _ = SIZES[size]
            _FRAMES[size] = _whole(world[1], _cam(world[2], w, h), w, h)
        return _FRAMES[size]
    return get


def _bands(t, n):
    r_loc = t.shape[1] // n
    return [t[:, b * r_loc:(b + 1) * r_loc] for b in range(n)]


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(
        shape, dtype=np.float32))


def _history(gb, seed):
    """A random svgf history whose prim and normal are gb's, so most hit
    pixels blend."""
    g = np.random.default_rng(seed)
    r = gb.shape[1]
    prev = g.random((svgf.SV_CH, r), dtype=np.float32)
    prev[svgf.SV_HIST] = g.integers(0, 9, r).astype(np.float32)
    prev = torch.as_tensor(prev)
    prev[svgf.SV_PRIM] = gb[tk.G_PRIMR]
    prev[svgf.SV_NORM:svgf.SV_NORM + 3] = gb[tk.G_NORM:tk.G_NORM + 3]
    return prev


def _band_run(kernel, tscene, cv, w, h, n, gb1, pt0, pt1):
    """(whole-frame twin's output, [each band twin's output])."""
    r = w * h
    r_loc, window, halo_s = band_layout(RenderConfig(width=w, height=h), n)
    gbs, pt0s, pt1s = _bands(gb1, n), _bands(pt0, n), _bands(pt1, n)
    out = []
    if kernel == "gbuffer":
        for b in range(n):
            out.append(gbuffer.gbuffer_ref(cv, cv, LOOPER, tscene.bvh,
                                           width=w, height=h,
                                           pix0=b * r_loc, r=r_loc))
        return gb1, out
    if kernel == "reuse":
        for b in range(n):
            pix0 = b * r_loc
            out.append(reuse.reuse_ref(
                gbs[b], haloed(pt0s, b, window, "cpu"), LOOPER,
                tscene.tables, pix0=pix0, prev_base=pix0 - window,
                window=window))
        return pt1, out
    if kernel == "temporal":
        rs = _rand((tk.RS_CH, r), 7)
        kw = dict(k=4, temporal=True, temporal_clamp=20)

        def merge(g, s, pix, prev, **band):
            return tk.temporal_pixels(g, s[0:3], s[3:6], s[6], s[7] * 4.0,
                                      pix, LOOPER, prev, **kw, **band)

        whole = merge(gb1, rs, torch.arange(r), pt0)
        for b, s in enumerate(_bands(rs, n)):
            pix0 = b * r_loc
            out.append(merge(gbs[b], s, torch.arange(pix0, pix0 + r_loc),
                             haloed(pt0s, b, window, "cpu"),
                             prev_base=pix0 - window, window=window))
        return whole, out
    if kernel == "spatial":
        acc = _rand((3, r), 3)
        kw = dict(width=w, height=h, neighbors=N_NB)
        offs = spatial.spatial_offsets(LOOPER, r, w, N_NB, RADIUS, "cpu")
        whole = spatial.spatial_shade_ref(offs, gb1, pt1, acc.clone(),
                                          LOOPER, 3, **kw)
        for b, a in enumerate(_bands(acc, n)):
            pix0 = b * r_loc
            offs = spatial.spatial_offsets(LOOPER, r_loc, w, N_NB, RADIUS,
                                           "cpu", pix0=pix0, halo=halo_s,
                                           r_total=r)
            out.append(spatial.spatial_shade_ref(
                offs, gbs[b], pt1s[b].contiguous(), a.clone(), LOOPER, 3,
                pt_ext=haloed(pt1s, b, halo_s, "cpu"), pix0=pix0, **kw))
        return whole, out
    if kernel == "svgf":
        color = _rand((3, r), 5)
        prev = _history(gb1, 6)
        whole = svgf.svgf_temporal_ref(gb1, color, prev)
        for b, c in enumerate(_bands(color, n)):
            pix0 = b * r_loc
            out.append(svgf.svgf_temporal_ref(
                gbs[b].contiguous(), c.contiguous(),
                haloed(_bands(prev, n), b, window, "cpu"),
                prev_base=pix0 - window, window=window))
        return whole, out
    raise AssertionError(kernel)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("size", SIZES)
def test_band_twin_equals_whole_frame_rows(world, frames, size, kernel):
    _, tscene, cam = world
    w, h, n = SIZES[size]
    gb1, pt0, pt1 = frames(size)
    if kernel in ("reuse", "temporal"):
        # the merge is live: some pixels took their history's sample
        assert float(pt1[tk.P_M].max()) > 4.0
    whole, bands = _band_run(kernel, tscene, _cam(cam, w, h), w, h, n,
                             gb1, pt0, pt1)
    r_loc = whole.shape[1] // n
    for b, got in enumerate(bands):
        want = whole[:, b * r_loc:(b + 1) * r_loc]
        assert got.shape == want.shape
        assert torch.equal(got, want), (b, (got != want).sum())


def test_band_guards():
    """The window is whole 1024-pixel tiles (the guard reuse_pallas
    lacks); a band lies inside its frame."""
    gb = torch.zeros(tk.GB_CH, 1024)
    rs = torch.zeros(tk.RS_CH, 1024)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tk.temporal_pixels(gb, rs[0:3], rs[3:6], rs[6], rs[7],
                           torch.arange(1024), 0, torch.zeros(16, 3072), k=4,
                           temporal=True, temporal_clamp=20, window=1536)
    with pytest.raises(ValueError, match="multiple of 1024"):
        svgf.svgf_temporal_ref(gb, torch.zeros(3, 1024),
                               torch.zeros(svgf.SV_CH, 2048), window=0)
    with pytest.raises(ValueError, match="outside the 128x8 frame"):
        tk.band_pixels(128, 8, pix0=512, r=1024)
    order = gbuffer.tile_order(384, 16, pix0=2048, r=2048)
    got = order[order >= 0]
    assert sorted(got.tolist()) == list(range(2048, 4096))


# ---- band 1 of 2 at 128x16 against the JAX wrappers ----

JW, JH, NJ = 128, 16, 2
JR = JW * JH
B1 = 1  # the band under test


@pytest.fixture(scope="module")
def jax_band(world):
    """Frames 0 and 1 of the whole-frame twins at 128x16 and band 1's
    layout: (gb1, pt0, pt1, r_loc, window, halo_s)."""
    _, tscene, cam = world
    gb1, pt0, pt1 = _whole(tscene, _cam(cam, JW, JH), JW, JH)
    return (gb1, pt0, pt1,
            *band_layout(RenderConfig(width=JW, height=JH), NJ))


def _j(t, c):
    """A port [C, b] tensor as the JAX [C, b/128, 128] pack."""
    return jnp.asarray(t.contiguous().numpy().reshape(c, -1, 128))


def _np(a, c):
    return np.asarray(a).reshape(c, -1)


def test_gbuffer_band_matches_jax(world, jax_band):
    scene, tscene, cam = world
    r_loc = jax_band[3]
    cv = fk.pack_camera(cam, JW, JH)
    g = r_loc // 128
    want = fk.gbuffer_pack_pallas(
        cv, cv, jnp.uint32(LOOPER), scene.tri_xform, scene.prim_attr,
        scene.mat_attr, scene.cluster_lo, scene.cluster_hi, width=JW,
        height=JH, pix0=B1 * r_loc,
        xy=fk.make_xy_grid(JW, JH)[:, B1 * g:(B1 + 1) * g], interpret=True)
    got = gbuffer.gbuffer_pack(_cam(cam, JW, JH), _cam(cam, JW, JH), LOOPER,
                               tscene.bvh, width=JW, height=JH,
                               pix0=B1 * r_loc, r=r_loc)
    fails, stats = parity.gb_report(_np(want, tk.GB_CH), got)
    assert not fails, (fails, stats)
    # the band's raster coordinates are the frame's
    assert float(got[tk.G_Y].min()) == (B1 * r_loc) // JW


def test_reuse_band_matches_jax(world, jax_band):
    scene, tscene, _ = world
    gb1, pt0, _, r_loc, window, _ = jax_band
    pix0 = B1 * r_loc
    gb = _bands(gb1, NJ)[B1].contiguous()
    prev = haloed(_bands(pt0, NJ), B1, window, "cpu")
    want = fk.reuse_pallas(
        _j(gb, tk.GB_CH), jnp.asarray(prev.numpy()), jnp.uint32(LOOPER),
        scene.light_verts, scene.light_normal, scene.light_radiance,
        scene.light_area, scene.light_center, scene.light_radius,
        scene.tri_xform, scene.cluster_lo, scene.cluster_hi,
        scene.sub_lo, scene.sub_hi, k=4, window=window, pix0=pix0,
        prev_base=pix0 - window, interpret=True)
    got = reuse.reuse(gb, prev, LOOPER, tscene.tables, tscene.bvh, width=JW,
                      pix0=pix0, prev_base=pix0 - window, window=window)
    fails, stats = parity.pt_report(_np(want, tk.PT_CH), got)
    assert not fails, (fails, stats)
    assert float(got[tk.P_M].max()) > 4.0  # history merged


def test_spatial_band_matches_jax(jax_band):
    gb1, _, pt1, r_loc, _, halo_s = jax_band
    pix0 = B1 * r_loc
    gb = _bands(gb1, NJ)[B1].contiguous()
    pt = _bands(pt1, NJ)[B1].contiguous()
    pt_ext = haloed(_bands(pt1, NJ), B1, halo_s, "cpu")
    acc = _rand((3, r_loc), 4)
    real = fk.pl.pallas_call
    captured = {}

    def spy(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            captured["offs"] = np.asarray(args[0])
            return call(*args)
        return run

    fk.pl.pallas_call = spy
    try:
        want = fk.spatial_shade_pallas.__wrapped__(
            _j(gb, tk.GB_CH), _j(pt, tk.PT_CH), jnp.asarray(pt_ext.numpy()),
            _j(acc, 3), jnp.uint32(LOOPER), jnp.int32(3), JW, JH, N_NB,
            RADIUS, True, True, pix0=pix0, halo=halo_s, r_total=JR,
            interpret=True)
    finally:
        fk.pl.pallas_call = real
    offs = spatial.spatial_offsets(LOOPER, r_loc, JW, N_NB, RADIUS, "cpu",
                                   pix0=pix0, halo=halo_s, r_total=JR)
    assert np.array_equal(offs.numpy(), captured["offs"])
    assert offs[..., 4].any()
    got = spatial.spatial_shade(offs, gb, pt, acc.clone(), LOOPER, 3,
                                width=JW, height=JH, neighbors=N_NB,
                                pt_ext=pt_ext, pix0=pix0)
    close = np.isclose(_np(want, 3), got.numpy(), rtol=1e-5, atol=1e-6)
    assert close.mean() >= 0.999, close.mean()


def test_svgf_band_matches_jax(jax_band):
    gb1, _, _, r_loc, window, _ = jax_band
    pix0 = B1 * r_loc
    gb = _bands(gb1, NJ)[B1].contiguous()
    color = _rand((3, r_loc), 8)
    prev = haloed(_bands(_history(gb1, 9), NJ), B1, window, "cpu")
    want = fk.svgf_temporal_pallas(
        _j(gb, tk.GB_CH), _j(color, 3), jnp.asarray(prev.numpy()),
        window=window, prev_base=pix0 - window, interpret=True)
    got = svgf.svgf_temporal(gb, color, prev, prev_base=pix0 - window,
                             window=window)
    np.testing.assert_allclose(got.numpy(), _np(want, svgf.SV_CH),
                               rtol=1e-5, atol=1e-6)
    hit = gb[tk.G_PRIMR] > -1.0
    assert float((got[svgf.SV_HIST][hit] > 0).float().mean()) > 0.5
