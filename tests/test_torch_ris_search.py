"""B7's light search (`csrc/reuse_bvh.cu`) through its CPU mirror in
`restir_tpu_torch.ops.kernels.reuse`, and the 2-D pixel tiles of B6 / B7.

- The segmented search (pass 1 keeps the running cdf after every S-th
  row; each pick re-scans one segment) picks the same rows and targets,
  bit for bit, as the full two-pass scan over every row, on env_scene()'s
  640-row tables (has_env) and many_light_scene(64, 24)'s 128-row tables
  at random shading points, for k = 1, 4, 8 and S = 8, 16, 32, and on
  hand-made target rows for the edge cases (a zero total, thresholds at
  or past the last cdf or NaN, a cdf equal to a threshold at a segment
  boundary, segments of zero targets, a light count that is not a
  multiple of S);
  it evaluates at most n_lights + k * S targets per pixel.
- Its picks match the plain twin's (`fused_di.ris_pixels`, a cumsum over
  the rows) on >= 99.5 % of lanes: the pick-match gate of
  tests/test_fused_di.py.
- The reduced target of env-tile rows equals the full light target bit
  for bit on every env row, and padding rows have target 0.
- The tile map of B6 / B7 covers every pixel once on ragged frames.
"""

import re

import numpy as np
import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.ops.kernels import _build, fused_di, gbuffer, reuse
from restir_tpu_torch.ops.kernels.fused_di import (
    G_DIR,
    G_MTYPE,
    G_NORM,
    G_POS,
    G_SHADE,
    GB_CH,
)
from restir_tpu_torch.scene.procedural import env_scene, many_light_scene

B = 512  # shading points per case
LOOPER = 7


@pytest.fixture(scope="module", params=["env", "many_lights"])
def world(request):
    """(tables, has_env, gb [GB_CH, B], pix) with random shading points
    around the scene's lights, from a numpy seed."""
    if request.param == "env":
        arrays, _ = env_scene()
        has_env = True
    else:
        arrays, _ = many_light_scene(64, 24)
        has_env = False
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
    """The search's picks against the plain twin's cumsum picks."""
    tables, has_env, gb, pix = world
    k = 4
    idx, _, _, _ = reuse.ris_search(gb, pix, LOOPER, tables, k=k,
                                    single_sided=True, has_env=has_env)
    _, psi = tables.light_rows(has_env)
    _, t = fused_di.ris_targets(gb, psi, True)
    cdf = torch.cumsum(t, dim=1)
    thr = reuse.thresholds(pix, LOOPER, k, cdf[:, -1])
    twin = torch.clamp((cdf[None] <= thr[:, :, None]).sum(dim=2),
                       max=psi.shape[0] - 1)
    assert float((idx == twin).float().mean()) >= 0.995


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
    """(blocks per SM by env build, the spacings) as csrc/reuse_bvh.cu
    declares them for its launch bounds and b7_seg."""
    src = (_build.SRC_DIR / "reuse_bvh.cu").read_text()
    blocks = re.search(r"constexpr int kBlocksPerSm = (\d+), "
                       r"kBlocksPerSmEnv = (\d+);", src)
    segs = re.search(r"constexpr int kSegs\[\] = \{([\d, ]+)\};", src)
    assert blocks and segs
    assert re.search(r"__launch_bounds__\(PIX_BLOCK,\s*HAS_ENV \? "
                     r"kBlocksPerSmEnv : kBlocksPerSm\)", src)
    return ({False: int(blocks[1]), True: int(blocks[2])},
            tuple(int(x) for x in segs[1].split(",")))


@pytest.mark.parametrize("n_area,has_env,seg", [(128, False, 8),
                                                (128, True, 16),
                                                (4, True, 16)])
def test_seg_fits_the_blocks_per_sm(n_area, has_env, seg):
    """B7's checkpoint spacing: 8 rows on 128 area lights, 16 with the
    env tiles, so that the blocks its launch bounds ask for fit an SM (the
    host mirror's constants are the kernel's); and at 640 light rows it
    stages less than the 80 KB of psi and light rows the first design
    held."""
    assert _b7_source_constants() == (reuse.BLOCKS_PER_SM, reuse.SEGS)
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
