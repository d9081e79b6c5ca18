"""B7's light search (`csrc/ris_search.cuh`, which B10 shares) through its
CPU mirror in `restir_tpu_torch.ops.kernels.reuse`, and the 2-D pixel
tiles of B6 / B7.

- The segmented search (pass 1 keeps the running cdf after every S-th
  row; each pick re-scans one segment) picks the same rows and targets,
  bit for bit, as the full two-pass scan over every row, on env_scene()'s
  640-row tables (has_env), many_light_scene(64, 24)'s 128-row tables,
  and the tables past the staged design: env_scene(n_lights=1100)'s
  2,200 area rows with the env tiles and many_light_scene(1225, 24)'s
  2,450 rows, at random shading points, for k = 1, 4, 8 and S = 8, 16,
  32 (and past the staged design the kernel's S for the scene, 200 and
  256), and on hand-made target rows for the edge cases (a zero total,
  thresholds at or past the last cdf or NaN, a cdf equal to a threshold
  at a segment boundary, segments of zero targets, a light count that
  is not a multiple of S); the kernel's blocked pass 1 (`search_streamed`:
  several pixels a thread, rows by chunk and group, a checkpoint every
  S rows) equals the full scan on hand-made rows at S = 48, 64 and 256;
  it evaluates at most n_lights + k * S targets per pixel.
- Its picks match, on >= 99.5 % of lanes (the pick-match gate of
  tests/test_fused_di.py), those of an independent plain formulation
  (`_plain_ris`: unfused float32 targets, a cumsum) and those of the
  twin (`fused_di.ris_targets`, rounded as the kernels round, and its
  row-order `cdf_rows`); on the tables past the staged design, the
  twin's on every lane.
- The reduced target of env-tile rows equals the full light target bit
  for bit on every env row, and padding rows have target 0.
- The host mirror sizes the search's checkpoints (its spacing S, the
  smallest multiple of 8 that fits, and its shared memory) as the
  kernel does, for B7 and for B10 (the env-less search), within
  SMEM_MAX and the blocks per SM of the search's launch bounds, around
  the limits of B7's staged design (2,416 area rows, 2,144 with env
  tiles) and of B10's first design (1,792 rows) and at 2,450 and 10,000
  rows; its constants are the sources'.
- The tile map of B6 / B7 covers every pixel once on ragged frames.
"""

import re

import numpy as np
import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.ops.kernels import (
    _build,
    fused_di,
    gbuffer,
    reuse,
    ris_cdf,
)
from restir_tpu_torch.ops.kernels.fused_di import (
    G_DIR,
    G_MTYPE,
    G_NORM,
    G_POS,
    G_SHADE,
    GB_CH,
)
from restir_tpu_torch.scene.procedural import env_scene, many_light_scene

from _plain_ris import plain_cdf, plain_targets

B = 512  # shading points per case
LOOPER = 7


WORLDS = {  # scene, has_env: 640, 128, 2,712 and 2,450 light rows
    "env": (lambda: env_scene(), True),
    "many_lights": (lambda: many_light_scene(64, 24), False),
    "env_2200": (lambda: env_scene(n_lights=1100), True),
    "many_lights_2450": (lambda: many_light_scene(1225, 24), False),
}


@pytest.fixture(scope="module", params=["env", "many_lights"])
def world(request):
    """(tables, has_env, gb [GB_CH, B], pix) with random shading points
    around the scene's lights, from a numpy seed."""
    return _world(request.param)


@pytest.fixture(scope="module", params=["env_2200", "many_lights_2450"])
def big_world(request):
    """As `world`, on tables past the staged design."""
    return _world(request.param)


def _world(name):
    make, has_env = WORLDS[name]
    arrays, _ = make()
    tables = convert.scene_from_numpy(arrays, "cpu").tables
    g = np.random.default_rng(3)
    lc = np.asarray(arrays.light_center, np.float32)
    lo, hi = lc.min(0) - 4.0, lc.max(0) + 4.0
    gb = np.zeros((GB_CH, B), np.float32)
    gb[G_POS:G_POS + 3] = (lo[:, None] + (hi - lo)[:, None]
                           * g.random((3, B))).astype(np.float32)
    for c in (G_NORM, G_DIR):
        v = g.normal(size=(3, B))
        gb[c:c + 3] = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    gb[G_MTYPE] = g.integers(0, 3, B)
    gb[G_SHADE] = 1.0
    gb[:, :16] = 0.0  # misses: zero position and normal
    pix = torch.as_tensor(g.permutation(1 << 20)[:B], dtype=torch.int64)
    return tables, has_env, torch.as_tensor(gb), pix


def _full(world, k):
    """The full two-pass scan on light_target over every row."""
    tables, has_env, gb, pix = world
    _, psi = tables.light_rows(has_env)
    t = reuse.light_target_rows(psi, reuse.ris_frame(gb), True)
    cdf = torch.zeros(B)
    for l in range(psi.shape[0]):
        cdf = cdf + t[:, l]
    return reuse.search_full(t, reuse.thresholds(pix, LOOPER, k, cdf))


@pytest.mark.parametrize("seg", [8, 16, 32])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_segmented_search_equals_full_scan(world, k, seg):
    tables, has_env, gb, pix = world
    idx_f, tq_f, total_f = _full(world, k)
    idx, tq, total, evaluated = reuse.ris_search(
        gb, pix, LOOPER, tables, k=k, single_sided=True, has_env=has_env,
        seg=seg)
    assert torch.equal(total, total_f)
    assert torch.equal(idx, idx_f)
    assert torch.equal(tq, tq_f)
    n_live = tables.n_lights + (reuse.N_ENV if has_env else 0)
    assert int(evaluated.min()) >= n_live
    assert int(evaluated.max()) <= n_live + k * seg
    # the search finds rows inside the segments, not only fallbacks
    assert float((idx < n_live).float().mean()) > 0.5


def test_picks_match_twin(world):
    """The search's picks against an independent plain formulation's
    (`_plain_ris`: targets as unfused float32 products, a cumsum), which
    shares no code with the search."""
    _twin_picks_match(world, 0.995, plain_targets, plain_cdf)


def test_picks_match_rounded_twin(world):
    """The search's picks against the twin's own (`fused_di.ris_targets`,
    which rounds as the kernels do, and its row-order `cdf_rows`)."""
    _twin_picks_match(world, 0.995, fused_di.ris_targets, fused_di.cdf_rows)


def _twin_picks_match(world, share, targets, cdf_of):
    """The search's picks equal those of the CDF `cdf_of(targets(...))`
    on at least `share` of the lanes."""
    tables, has_env, gb, pix = world
    k = 4
    idx, _, _, _ = reuse.ris_search(gb, pix, LOOPER, tables, k=k,
                                    single_sided=True, has_env=has_env)
    _, psi = tables.light_rows(has_env)
    _, t = targets(gb, psi, True)
    cdf = cdf_of(t)
    thr = reuse.thresholds(pix, LOOPER, k, cdf[:, -1])
    twin = torch.clamp((cdf[None] <= thr[:, :, None]).sum(dim=2),
                       max=psi.shape[0] - 1)
    assert float((idx == twin).float().mean()) >= share


def test_env_target_equals_light_target(world):
    tables, has_env, gb, _ = world
    _, psi = tables.light_rows(has_env)
    f = reuse.ris_frame(gb)
    full = reuse.light_target_rows(psi, f, True)
    t, n_live = reuse.search_targets(gb, tables, single_sided=True,
                                     has_env=has_env)
    assert torch.equal(t, full)
    assert not bool(full[:, n_live:].any())
    if has_env:
        n = tables.n_lights
        env = reuse.env_target_rows(psi[n:n_live], f)
        assert torch.equal(env, full[:, n:n_live])
        assert float((env > 0).float().mean()) > 0.2


def _edge_rows():
    """Hand-made target rows [b, 100] (integers, so every cdf is exact),
    with 90 rows that hold lights: a zero row, a row of one light,
    rows with zero segments, and random rows."""
    g = np.random.default_rng(9)
    t = g.integers(0, 3, (12, 100)).astype(np.float32)
    t[:, 90:] = 0.0
    t[0] = 0.0  # total 0
    t[1] = 0.0
    t[1, 89] = 5.0  # one light, in the last (partial) segment
    t[2, 16:48] = 0.0  # two zero segments at S = 16
    t[3, :80] = 0.0
    return torch.as_tensor(t)


@pytest.mark.parametrize("seg", [8, 16, 32])
@pytest.mark.parametrize("case", ["random", "at_checkpoint", "past_total",
                                  "at_total", "zero", "nan"])
def test_search_edge_cases(case, seg):
    t = _edge_rows()
    n_live = 90
    b = t.shape[0]
    total = t.sum(dim=1)  # exact: integer sums
    ck = torch.cumsum(t, dim=1)
    if case == "random":
        u = torch.as_tensor(np.random.default_rng(seg).random((4, b)),
                            dtype=torch.float32)
        thr = u * total
    elif case == "at_checkpoint":
        # a cdf equal to thr at each segment boundary: strict > skips it
        thr = torch.stack([ck[:, min(c * seg, n_live) - 1]
                           for c in range(1, 4)])
    elif case == "past_total":
        thr = torch.stack([total + 1.0, torch.full((b,), float("inf"))])
    elif case == "at_total":
        thr = total[None].clone()
    elif case == "nan":  # a NaN total: no row exceeds its threshold
        thr = torch.full((2, b), float("nan"))
    else:
        thr = torch.zeros((3, b))
        t[:] = 0.0
    idx_f, tq_f, _ = reuse.search_full(t, thr)
    idx, tq, _, evaluated = reuse.search_seg(t, n_live, thr, seg)
    assert torch.equal(idx, idx_f)
    assert torch.equal(tq, tq_f)
    k = thr.shape[0]
    assert int(evaluated.max()) <= n_live + k * seg
    if case in ("past_total", "at_total", "zero", "nan"):
        assert bool((idx == t.shape[1] - 1).all())


def test_search_fallback_takes_last_light_row():
    """With every row a light (no padding), the fallback's target is the
    last row's own."""
    t = torch.as_tensor(np.random.default_rng(4).integers(
        1, 4, (6, 48)).astype(np.float32))
    thr = t.sum(dim=1)[None]
    idx_f, tq_f, _ = reuse.search_full(t, thr)
    idx, tq, _, _ = reuse.search_seg(t, 48, thr, 16)
    assert torch.equal(idx, idx_f) and torch.equal(tq, tq_f)
    assert torch.equal(tq[0], t[:, 47])


def _b7_source_constants():
    """(threads a block, pixels a thread, blocks per SM, chunk rows, group
    rows) of the light search as csrc/ris_search.cuh declares them for
    its launch bounds, b7_seg and b7_smem."""
    src = (_build.SRC_DIR / "ris_search.cuh").read_text()
    shape = re.search(r"constexpr int kSearchBlock = (\d+), kSearchP = "
                      r"(\d+), kSearchBlocks = (\d+);", src)
    group = re.search(r"constexpr int kChunkRows = kSearchBlock / 4, "
                      r"kGroup = (\d+);", src)
    assert shape and group
    block, p, search_blocks = shape.groups()
    assert "__launch_bounds__(kSearchBlock, kSearchBlocks)" in src
    assert "(size_t)2 * kChunkRows * 64 + (size_t)n_env * 20" in src
    assert "(size_t)n_seg * kSearchPixels * sizeof(float)" in src
    assert "s += kGroup;" in src
    return (int(block), int(p), int(search_blocks), int(block) // 4,
            int(group[1]))


def _mirror_constants():
    return (reuse.SEARCH_BLOCK, reuse.SEARCH_P, reuse.SEARCH_BLOCKS_PER_SM,
            reuse.CHUNK_ROWS, reuse.GROUP)


def _fits(n_area, has_env, seg):
    """Whether the search's blocks per SM fit an H100 SM at spacing seg."""
    n_live = n_area + (reuse.N_ENV if has_env else 0)
    smem = reuse.smem_bytes(n_area, has_env, n_live, seg)
    return (reuse.SEARCH_BLOCKS_PER_SM * (smem + reuse.SMEM_BLOCK_RESERVED)
            <= reuse.SMEM_SM)


@pytest.mark.parametrize("n_area,has_env,seg", [(128, False, 8),
                                                (128, True, 16),
                                                (4, True, 16)])
def test_seg_fits_the_blocks_per_sm(n_area, has_env, seg):
    """B7's checkpoint spacing: 8 rows on 128 area lights, 16 with the
    env tiles, so that the blocks the search's launch bounds ask for fit
    an SM (the host mirror's constants are the kernel's) and 8 rows less
    would not; at 640 light rows a block holds 98 KB: the chunk buffer,
    the env tiles' compact rows and 40 checkpoints of 512 pixels."""
    assert _b7_source_constants() == _mirror_constants()
    assert reuse.seg_for(n_area, has_env) == seg
    n_live = n_area + (reuse.N_ENV if has_env else 0)
    smem = reuse.smem_bytes(n_area, has_env, n_live, seg)
    assert _fits(n_area, has_env, seg)
    if seg > reuse.GROUP:  # the next smaller spacing would not fit
        assert not _fits(n_area, has_env, seg - reuse.GROUP)
    if n_live == 640:
        assert smem == 2 * 64 * 64 + 512 * 20 + 40 * 512 * 4


@pytest.mark.parametrize("has_env", [False, True])
@pytest.mark.parametrize("n_area", [1792, 1920, 2144, 2145, 2416, 2417,
                                    2450, 10000])
def test_build_choice_fits_shared_memory(n_area, has_env):
    """The one build's sizing around the tables B7's staged design held
    (2,416 area rows, 2,144 with the env tiles) and B10's first design
    staged (1,792 rows), and at 2,450 and 10,000 rows: the search's
    shared memory fits the blocks per SM of its launch bounds within
    SMEM_MAX at the smallest spacing S, a multiple of GROUP, that does
    (48 at 2,450 rows, 200 at 10,000); B7 and B10 size it alike."""
    b7_src, b10_src = (_build.SRC_DIR / "reuse_bvh.cu").read_text(), (
        _build.SRC_DIR / "ris_cdf.cu").read_text()
    assert _b7_source_constants() == _mirror_constants()
    assert reuse.CHUNK_ROWS == reuse.SEARCH_BLOCK // 4
    assert "b7_seg(n_area, false, &seg)" in b10_src
    assert "launch_ris_search<false, false>(CdfIo{" in b10_src
    assert "b7_seg(n_area, HAS_ENV, &seg)" in b7_src
    assert "launch_ris_search<COUNT, HAS_ENV>(" in b7_src
    # B10 (no env rows)
    b10_smem = ris_cdf.smem_bytes(n_area)
    assert b10_smem == reuse.smem_bytes(n_area, False, n_area,
                                        reuse.seg_for(n_area, False))
    assert _fits(n_area, False, reuse.seg_for(n_area, False))
    # B7
    seg = reuse.seg_for(n_area, has_env)
    n_live = n_area + (reuse.N_ENV if has_env else 0)
    smem = reuse.smem_bytes(n_area, has_env, n_live, seg)
    assert smem <= fused_di.SMEM_MAX
    assert _fits(n_area, has_env, seg)
    assert seg >= reuse.GROUP and seg % reuse.GROUP == 0
    if seg > reuse.GROUP:  # the next smaller spacing would not fit
        assert not _fits(n_area, has_env, seg - reuse.GROUP)
    # a pick re-scans one segment: at most n_live + K * S targets
    assert seg <= max(64, n_live // 32)
    if n_area in (2450, 10000) and not has_env:
        assert seg == {2450: 48, 10000: 200}[n_area]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_streamed_spacing_search_equals_full_scan(big_world, k):
    """The search (`reuse.search_streamed`, as the kernel's blocks,
    chunks and groups run it) at the spacings past the staged design
    (the mirror's S for the scene, 200, the spacing at 10,000 rows, and
    256, its first design's there) picks what the full scan picks, bit
    for bit, and the twin's picks are the search's."""
    tables, has_env, gb, pix = big_world
    idx_f, tq_f, total_f = _full(big_world, k)
    n = tables.n_lights
    assert reuse.seg_for(n, has_env) > 32  # past the staged design's
    if k == 4:
        _twin_picks_match(big_world, 1.0, fused_di.ris_targets,
                          fused_di.cdf_rows)
    for seg in sorted({reuse.seg_for(n, has_env), 200, 256}):
        idx, tq, total, evaluated = reuse.ris_search(
            gb, pix, LOOPER, tables, k=k, single_sided=True,
            has_env=has_env, seg=seg)
        assert torch.equal(total, total_f)
        assert torch.equal(idx, idx_f)
        assert torch.equal(tq, tq_f)
        n_live = n + (reuse.N_ENV if has_env else 0)
        assert int(evaluated.max()) <= n_live + k * seg


def _blocked_rows(l_pad):
    """Hand-made targets [75, l_pad] (integers, so every cdf is exact):
    517 area rows and 45 env rows hold lights, the rest are padding; a
    zero pixel, a pixel whose one light is the last row, a pixel with
    zero segments, random pixels."""
    g = np.random.default_rng(11)
    t = g.integers(0, 3, (75, l_pad)).astype(np.float32)
    t[:, 562:] = 0.0
    t[0] = 0.0  # total 0
    t[1] = 0.0
    t[1, 561] = 4.0  # one light, in the last (partial) segment
    t[2, 64:320] = 0.0  # zero segments at S = 64, one at 256
    return torch.as_tensor(t)


@pytest.mark.parametrize("seg", [48, 64, 256])
@pytest.mark.parametrize("case", ["random", "at_checkpoint", "at_row",
                                  "zero", "last_segment", "fallback"])
def test_blocked_pass1_equals_full_scan(case, seg):
    """The search kernel's pass 1 (`reuse.search_streamed`: the
    pixels SEARCH_P a thread in blocks of 8 threads, here 3 with a ragged
    tail; the area rows by chunk in groups with a checkpoint test once a
    group, then the env rows from the first group boundary) picks what
    the full scan picks, bit for bit, and evaluates what the plain
    segmented search (`search_seg`) evaluates: on random targets,
    thresholds equal to the cdf at a segment boundary and mid-segment
    (strict > skips them), zero targets, a light in the last partial
    segment and the fallback row of a table without padding (its own
    target)."""
    n_area, n_live = 517, 562
    t = _blocked_rows(n_live if case == "fallback" else 600)
    total = t.sum(dim=1)
    ck = torch.cumsum(t, dim=1)
    b = t.shape[0]
    g = np.random.default_rng(seg)
    if case == "random":
        thr = torch.as_tensor(g.random((4, b)), dtype=torch.float32) * total
    elif case == "at_checkpoint":
        thr = torch.stack([ck[:, min(c * seg, n_live) - 1]
                           for c in (1, 2)])
    elif case == "at_row":
        thr = torch.stack([ck[:, r] for r in (seg // 2 + 3, n_area + 7)])
    elif case == "zero":
        t[:] = 0.0
        thr = torch.zeros((3, b))
    elif case == "last_segment":
        thr = torch.stack([total - 0.5, torch.full((b,), 0.25)])
    else:
        thr = torch.stack([total, torch.full((b,), float("inf"))])
    idx_f, tq_f, total_f = reuse.search_full(t, thr)
    idx, tq, tot, evaluated = reuse.search_streamed(
        t, n_area, n_live, thr, seg, p=reuse.SEARCH_P, block=8)
    assert torch.equal(idx, idx_f)
    assert torch.equal(tq, tq_f)
    assert torch.equal(tot, total_f)
    assert torch.equal(evaluated, reuse.search_seg(t, n_live, thr, seg)[3])
    assert int(evaluated.max()) <= n_live + thr.shape[0] * seg
    if case == "last_segment":
        assert int(idx[0, 1]) == n_live - 1
    if case in ("zero", "fallback"):
        assert bool((idx == t.shape[1] - 1).all())
    if case == "fallback":
        assert torch.equal(tq[0], t[:, -1])


@pytest.mark.parametrize("w,h", [(200, 72), (1920, 1080), (37, 5)])
def test_tile_order_is_a_permutation(w, h):
    p = gbuffer.tile_order(w, h)
    assert p.numel() % gbuffer.BLOCK == 0
    v = p[p >= 0]
    assert torch.equal(torch.sort(v).values, torch.arange(w * h))
    # each warp is an 8x4 patch of the frame (where it lies inside it)
    warp = p.view(-1, 32)
    ok = (warp >= 0).all(dim=1)
    x, y = warp[ok] % w, warp[ok] // w
    assert bool(((x.max(1).values - x.min(1).values) == 7).all())
    assert bool(((y.max(1).values - y.min(1).values) == 3).all())
