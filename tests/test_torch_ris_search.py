"""B7's light search (`csrc/reuse_bvh.cu`) through its CPU mirror in
`restir_tpu_torch.ops.kernels.reuse`, and the 2-D pixel tiles of B6 / B7.

- The segmented search (pass 1 keeps the running cdf after every S-th
  row; each pick re-scans one segment) picks the same rows and targets,
  bit for bit, as the full two-pass scan over every row, on env_scene()'s
  640-row tables (has_env), many_light_scene(64, 24)'s 128-row tables,
  and the tables past the staged build: env_scene(n_lights=1100)'s 2,200
  area rows with the env tiles and many_light_scene(1225, 24)'s 2,450
  rows, at random shading points, for k = 1, 4, 8 and S = 8, 16, 32
  (and the streamed build's S: its own, 64, 128, 256), and on
  hand-made target rows for the edge cases (a zero total, thresholds at
  or past the last cdf or NaN, a cdf equal to a threshold at a segment
  boundary, segments of zero targets, a light count that is not a
  multiple of S);
  it evaluates at most n_lights + k * S targets per pixel.
- Its picks match, on >= 99.5 % of lanes (the pick-match gate of
  tests/test_fused_di.py), those of an independent plain formulation
  (`_plain_ris`: unfused float32 targets, a cumsum) and those of the
  twin (`fused_di.ris_targets`, rounded as the kernels round, and its
  row-order `cdf_rows`); on the tables past the staged builds, the
  twin's on every lane.
- The reduced target of env-tile rows equals the full light target bit
  for bit on every env row, and padding rows have target 0.
- The host mirror picks B7's build (staged or streamed), its spacing
  and its shared memory as the kernel does, and B10's (always B7's
  env-less streamed search), within SMEM_MAX and the blocks per SM of
  B7's launch bounds, around the limits of B7's staged build (2,416
  area rows, 2,144 with env tiles) and of B10's first design (1,792
  rows) and at 2,450 and 10,000 rows; its constants are the sources'.
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
    """As `world`, on tables past the staged builds."""
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
    """(blocks per SM by env build, the spacings, the streamed build's
    chunk rows) as csrc/ris_search.cuh declares them for B7's launch
    bounds (csrc/reuse_bvh.cu), b7_seg and b7_smem."""
    src = (_build.SRC_DIR / "ris_search.cuh").read_text()
    b7_src = (_build.SRC_DIR / "reuse_bvh.cu").read_text()
    blocks = re.search(r"constexpr int kBlocksPerSm = (\d+), "
                       r"kBlocksPerSmEnv = (\d+);", src)
    segs = re.search(r"constexpr int kSegs\[\] = \{([\d, ]+)\};", src)
    chunk = re.search(r"constexpr int kChunkRows = (\d+);", src)
    assert blocks and segs and chunk
    assert re.search(r"__launch_bounds__\(PIX_BLOCK,\s*HAS_ENV \? "
                     r"kBlocksPerSmEnv : kBlocksPerSm\)", b7_src)
    assert re.search(r"\(stream \? 2 \* kChunkRows : n_area\) \* 64", src)
    return ({False: int(blocks[1]), True: int(blocks[2])},
            tuple(int(x) for x in segs[1].split(",")), int(chunk[1]))


@pytest.mark.parametrize("n_area,has_env,seg", [(128, False, 8),
                                                (128, True, 16),
                                                (4, True, 16)])
def test_seg_fits_the_blocks_per_sm(n_area, has_env, seg):
    """B7's checkpoint spacing: 8 rows on 128 area lights, 16 with the
    env tiles, so that the blocks its launch bounds ask for fit an SM (the
    host mirror's constants are the kernel's); and at 640 light rows it
    stages less than the 80 KB of psi and light rows the first design
    held."""
    assert _b7_source_constants() == (reuse.BLOCKS_PER_SM, reuse.SEGS,
                                      reuse.CHUNK_ROWS)
    assert reuse.seg_for(n_area, has_env) == seg
    n_live = n_area + (reuse.N_ENV if has_env else 0)
    smem = reuse.smem_bytes(n_area, has_env, n_live, seg)
    blocks = reuse.BLOCKS_PER_SM[has_env]
    assert blocks * (smem + reuse.SMEM_BLOCK_RESERVED) <= reuse.SMEM_SM
    if seg > reuse.SEGS[0]:  # the next smaller spacing would not fit
        smaller = reuse.smem_bytes(n_area, has_env, n_live, seg // 2)
        assert blocks * (smaller + reuse.SMEM_BLOCK_RESERVED) > reuse.SMEM_SM
    if n_live == 640:
        assert smem < 640 * 128


# the largest light counts B7's staged build holds: 2,416 area rows
# (2,144 with the env tiles)
B7_STAGED_MAX = {False: 2416, True: 2144}


@pytest.mark.parametrize("has_env", [False, True])
@pytest.mark.parametrize("n_area", [1792, 1920, 2144, 2145, 2416, 2417,
                                    2450, 10000])
def test_build_choice_fits_shared_memory(n_area, has_env):
    """B7's choice of build from the table size: the staged build while
    its tables fit SMEM_MAX, else the streamed one, whose shared memory
    fits the blocks per SM of B7's launch bounds with the smallest
    spacing S that does (a power of two from 8: 64 at 2,450 rows, 256 at
    10,000). B10 runs the env-less streamed search at every size (its
    first design staged l_pad rows of 128 B: at most 1,792)."""
    b7_src, b10_src = (_build.SRC_DIR / "reuse_bvh.cu").read_text(), (
        _build.SRC_DIR / "ris_cdf.cu").read_text()
    assert "constexpr int BLOCK = 256;" in b10_src
    assert _b7_source_constants()[2] == reuse.CHUNK_ROWS == gbuffer.BLOCK // 4
    assert "b7_seg(n_area, false, true, &seg)" in b10_src
    assert "b7_smem(n_area, false, seg, true)" in b10_src
    assert "ris_select_seg<false, false, true>" in b10_src
    # B10 (no env rows)
    b10_smem = ris_cdf.smem_bytes(n_area)
    assert b10_smem == reuse.smem_bytes(
        n_area, False, n_area, reuse.seg_for(n_area, False, True), True)
    assert (reuse.BLOCKS_PER_SM[False]
            * (b10_smem + reuse.SMEM_BLOCK_RESERVED) <= reuse.SMEM_SM)
    # B7
    streamed = reuse.streamed_for(n_area, has_env)
    assert streamed == (n_area > B7_STAGED_MAX[has_env])
    assert "b7_seg(n_area, HAS_ENV, STREAM, &seg)" in b7_src
    seg = reuse.seg_for(n_area, has_env, streamed)
    n_live = n_area + (reuse.N_ENV if has_env else 0)
    smem = reuse.smem_bytes(n_area, has_env, n_live, seg, streamed)
    assert smem <= fused_di.SMEM_MAX
    blocks = reuse.BLOCKS_PER_SM[has_env]
    if streamed:
        assert blocks * (smem + reuse.SMEM_BLOCK_RESERVED) <= reuse.SMEM_SM
        assert seg >= reuse.SEGS[0] and seg & (seg - 1) == 0
        if seg > reuse.SEGS[0]:  # the next smaller spacing would not fit
            smaller = reuse.smem_bytes(n_area, has_env, n_live, seg // 2,
                                       True)
            assert (blocks * (smaller + reuse.SMEM_BLOCK_RESERVED)
                    > reuse.SMEM_SM)
        # a pick re-scans one segment: at most n_live + K * S targets
        assert seg <= max(64, n_live // 32)
    else:
        assert seg in reuse.SEGS
    if n_area in (2450, 10000) and not has_env:
        assert seg == {2450: 64, 10000: 256}[n_area]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_streamed_spacing_search_equals_full_scan(big_world, k):
    """The search at the streamed build's spacings (the mirror's S for
    the scene, and 256, the spacing at 10,000 rows) picks what the full
    scan picks, bit for bit, and the twin's picks are the search's."""
    tables, has_env, gb, pix = big_world
    idx_f, tq_f, total_f = _full(big_world, k)
    n = tables.n_lights
    assert reuse.streamed_for(n, has_env)
    if k == 4:
        _twin_picks_match(big_world, 1.0, fused_di.ris_targets,
                          fused_di.cdf_rows)
    for seg in sorted({reuse.seg_for(n, has_env, True), 256}):
        idx, tq, total, evaluated = reuse.ris_search(
            gb, pix, LOOPER, tables, k=k, single_sided=True,
            has_env=has_env, seg=seg)
        assert torch.equal(total, total_f)
        assert torch.equal(idx, idx_f)
        assert torch.equal(tq, tq_f)
        n_live = n + (reuse.N_ENV if has_env else 0)
        assert int(evaluated.max()) <= n_live + k * seg


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
