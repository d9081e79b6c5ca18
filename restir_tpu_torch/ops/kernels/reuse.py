"""Kernel B7: RIS + the winner's shadow ray through an MTBVH any-hit walk,
then B1's temporal merge; and the plain PyTorch twin of the whole.

Port of `restir_tpu.ops.pallas.fused_di.reuse_pallas` (its kernels
`_ris_select_kernel`, `_vis_sorted_kernel`, `_vis_resident_kernel` and
`_merge_sorted_kernel`): per pixel of a gb pack, K-candidate CDF RIS with a
single-draw winner, the winner's shadow ray, and the temporal merge with
the previous frame's reuse pack. Returns pt [PT_CH, R].

On CUDA tensors `reuse` launches `csrc/reuse_bvh.cu` (writes the candidate
pack rs [RS_CH, R]) and then B1's `di_temporal_kernel` through
`fused_di.temporal_cuda`; on CPU tensors it takes the twin `reuse_ref`
(B1's stages: `ris_pixels`, the brute `shadow_pixels`, `temporal_pixels`).
Nothing falls back. `has_env` adds the env tiles to the light CDF.

A row band (`restir_tpu_torch.parallel`) passes its first global pixel
`pix0` (the RIS and temporal draws' key, and where its 2-D tiles start),
its previous pack with +-`window` halos and that pack's first global
pixel `prev_base`, as the JAX `reuse_pallas(pix0=, prev_base=, window=)`.

B7 finds its K picks with a search that evaluates each light row about
once, a kernel of its own that B10 shares (`csrc/ris_search.cuh`): pass
1 sums the light targets in row order and keeps the running cdf after
every S-th row, then each pick re-scans only the segment whose
checkpoint first exceeds its threshold. The adds are the full two-pass
scan's, in its order, so the picks are its picks bit for bit. The search
streams the psi rows through a double buffer of `CHUNK_ROWS` rows in
shared memory, `SEARCH_P` pixels a thread, each row read once for all of
a thread's pixels, so any light count fits a block; S is the smallest
multiple of `GROUP` whose checkpoints fit (the kernel picks S for the
card, `seg_cuda`; `seg_for` is its host mirror: 8 on 128 light rows, 16
on 640 with the env tiles, 48 on 2,450, 200 on 10,000); each pick
re-scans its segment from device memory. It writes each pixel's
candidate to rs; the shadow walk, a second launch, zeroes an occluded
winner's weight. `ris_search` /
`search_streamed` (the kernel's blocks, chunks and groups), `search_seg`
and `search_full` mirror the search on CPU tensors (sequential float32
adds over rows, vectorised over pixels) for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import rng
from . import _build, fused_di
from .fused_di import (
    CTR_RIS,
    ENV_TH,
    ENV_TW,
    GB_CH,
    MAX_K,
    PT_CH,
    RS_CH,
    _check,
    _fma32,
    light_target_rows,
    ris_frame,
)
from .gbuffer import _check_bvh
from .tables import BvhTables, ResidentTables

launches = 0  # B7 launches (its walk)
search_launches = 0  # launches of the light search (B7 and B10)

N_ENV = ENV_TH * ENV_TW  # env-tile light rows after the area lights
# Host mirror of csrc/ris_search.cuh's b7_seg, for the CPU search and the
# tests: the search's shape (kSearchBlock, kSearchP, kSearchBlocks,
# kChunkRows, kGroup) and an H100 SM's shared memory. The tests hold
# these against the source and the mirror against the kernel's S.
SEARCH_BLOCK = 256  # threads a block of the search
SEARCH_P = 2  # pixels a thread
SEARCH_BLOCKS_PER_SM = 2  # blocks an SM of its launch bounds
CHUNK_ROWS = 64  # area rows a chunk of its pass 1
GROUP = 8  # rows of an unrolled group; S is a multiple
SMEM_SM = 233472  # shared memory of one Hopper SM (bytes)
SMEM_BLOCK_RESERVED = 1024  # shared memory the system keeps per block


def smem_bytes(n_area: int, has_env: bool, n_live: int, seg: int) -> int:
    """The search's shared memory per block: the double buffer of 2 x
    CHUNK_ROWS psi rows (64 B), the env tiles' compact rows (d_tile,
    radius | luminance: 20 B) and one cdf checkpoint per `seg` rows for
    each of the block's SEARCH_BLOCK x SEARCH_P pixels."""
    n_env = N_ENV if has_env else 0
    return (2 * CHUNK_ROWS * 64 + n_env * 20
            + -(-n_live // seg) * SEARCH_BLOCK * SEARCH_P * 4)


def seg_for(n_area: int, has_env: bool) -> int:
    """B7's checkpoint spacing on an H100 (the host mirror of the
    kernel's b7_seg): the smallest multiple of GROUP whose checkpoints
    still leave room in shared memory for the search's blocks per SM
    (each pick re-scans that many rows): 8 on 128 light rows, 16 on 640
    (128 area lights and the env tiles), 48 on 2,450 area rows, 200 on
    10,000."""
    n_live = n_area + (N_ENV if has_env else 0)
    cap = SMEM_SM // SEARCH_BLOCKS_PER_SM - SMEM_BLOCK_RESERVED
    seg = GROUP
    while seg < n_live and smem_bytes(n_area, has_env, n_live, seg) > cap:
        seg += GROUP
    return seg


def seg_cuda(n_area: int, has_env: bool, device=None) -> int:
    """The checkpoint spacing B7's search takes on `device` (the current
    CUDA device when None; its b7_seg)."""
    lib = _build.library()
    with _build.on_device(device):
        seg = lib.restir_reuse_bvh_seg(n_area, int(has_env))
    if seg < 0:
        _build.check(-seg, "restir_reuse_bvh_seg")
    return seg


# ---- mirror of B7's light search (CPU tests) ----


def env_target_rows(psi_env, f):
    """The reduced target of env-tile rows (psi (d_tile, 0 | 0, 0, 0, 1 |
    0, 0, 0, 1, 0)): b = 1 and d2 = 1, so the target is lum * max(n.d,
    0.1 rad) above the horizon band, which equals `light_target_rows` bit
    for bit."""
    nx, ny, nz = (c[:, None] for c in f["n"])
    d = [psi_env[:, c][None] for c in range(3)]
    a = _fma32(d[2], nz, _fma32(d[0], nx, d[1] * ny))
    rad = psi_env[:, 14][None]
    above = (a + rad) > 0.0
    a_eff = torch.maximum(a, 0.1 * rad)
    return torch.where(above, psi_env[:, 13][None] * a_eff, 0.0)


def search_targets(gb, tables: ResidentTables, *, single_sided,
                   has_env=False):
    """(targets [b, l_pad] as B7 evaluates them, rows that hold lights):
    the area rows through `light_target_rows`, the env rows through
    `env_target_rows`, the padding rows 0."""
    _, psi = tables.light_rows(has_env)
    f = ris_frame(gb)
    n_area = tables.n_lights
    n_live = n_area + (N_ENV if has_env else 0)
    t = torch.zeros((gb.shape[1], psi.shape[0]), dtype=torch.float32,
                    device=gb.device)
    t[:, :n_area] = light_target_rows(psi[:n_area], f, single_sided)
    if has_env:
        t[:, n_area:n_live] = env_target_rows(psi[n_area:n_live], f)
    return t, n_live


def thresholds(pix, looper, k, total):
    """thr_j = u_j * total [k, b] (the RIS draws' first uniform)."""
    return torch.stack([rng.uniform4(pix, looper, CTR_RIS + j,
                                     rng.SALT_RESTIR)[0] * total
                        for j in range(k)])


def search_full(t, thr):
    """The two-pass scan over every row (B1's search): idx_j is the first
    row whose running cdf exceeds thr_j, else the last row with its own
    target. Returns (idx [k, b], tq [k, b], total [b])."""
    b, l_pad = t.shape
    k = thr.shape[0]
    cdf = torch.zeros(b, dtype=torch.float32, device=t.device)
    for l in range(l_pad):
        cdf = cdf + t[:, l]
    total = cdf
    idx = torch.full((k, b), -1, dtype=torch.int64, device=t.device)
    tq = torch.zeros((k, b), dtype=torch.float32, device=t.device)
    cdf = torch.zeros_like(total)
    for l in range(l_pad):
        cdf = cdf + t[:, l]
        hit = (idx < 0) & (cdf[None] > thr)
        idx = torch.where(hit, l, idx)
        tq = torch.where(hit, t[:, l][None], tq)
    miss = idx < 0
    idx = torch.where(miss, l_pad - 1, idx)
    tq = torch.where(miss, t[:, l_pad - 1][None], tq)
    return idx, tq, total


def search_seg(t, n_live, thr, seg):
    """B7's search: pass 1 over the rows that hold lights keeps the cdf
    after every `seg`-th row (and after the last), each pick re-scans the
    one segment whose checkpoint first exceeds thr_j. Returns (idx [k, b],
    tq [k, b], total [b], targets evaluated per pixel [b]); equal to
    `search_full` bit for bit when every target is >= 0."""
    cdf = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
    ck = []
    for l in range(n_live):
        cdf = cdf + t[:, l]
        if (l + 1) % seg == 0 or l == n_live - 1:
            ck.append(cdf)
    return _picks(t, n_live, thr, seg, ck)


def search_streamed(t, n_area, n_live, thr, seg, p=SEARCH_P,
                    block=SEARCH_BLOCK):
    """The search kernel's form of `search_seg` (rows [0,
    n_area) area rows, [n_area, n_live) env rows): the pixels in blocks of
    `block` threads, pixel q of thread i at q * block + i of its block;
    pass 1 adds each row for a thread's `p` pixels, the area rows chunk by
    chunk of CHUNK_ROWS in groups of GROUP, testing for a checkpoint once
    a group, the env rows in groups from the first multiple of GROUP, and
    keeps pixel q's checkpoint c in column q * block + i of the block's
    row c; the picks read each pixel's column back. Equal to
    `search_full` bit for bit when every target is >= 0."""
    b, _ = t.shape
    dev = t.device
    pixels = block * p
    n_blocks = -(-b // pixels)
    # [block, p, thread] pixels; the ragged tail's pixels hold target 0
    tb = torch.zeros((n_blocks * pixels, t.shape[1]), dtype=torch.float32,
                     device=dev)
    tb[:b] = t
    tb = tb.view(n_blocks, p, block, -1)
    cdf = torch.zeros((n_blocks, p, block), dtype=torch.float32, device=dev)
    rows = []  # checkpoint rows [n_blocks, p * block]

    def add(l):
        nonlocal cdf
        cdf = cdf + tb[..., l]

    def store():
        rows.append(cdf.reshape(n_blocks, pixels))

    for l0 in range(0, n_area, CHUNK_ROWS):
        n = min(CHUNK_ROWS, n_area - l0)
        i = 0
        while i + GROUP <= n:
            for u in range(GROUP):
                add(l0 + i + u)
            i += GROUP
            if (l0 + i) % seg == 0:
                store()
        for l in range(l0 + i, l0 + n):  # the table's last rows
            add(l)
    l = n_area
    while l < n_live and l % GROUP:
        add(l)
        l += 1
    if l > n_area and l % GROUP == 0 and l % seg == 0:
        store()
    while l + GROUP <= n_live:
        for u in range(GROUP):
            add(l + u)
        l += GROUP
        if l % seg == 0:
            store()
    for l in range(l, n_live):
        add(l)
    if n_live % seg:
        store()
    # pixel j's checkpoints: its block's rows at its column
    j = torch.arange(b, device=dev)
    blk, col = j // pixels, j % pixels
    ck = [r[blk, col] for r in rows]
    return _picks(t, n_live, thr, seg, ck)


def _picks(t, n_live, thr, seg, ck):
    """The K picks of `search_seg` from pass 1's checkpoints ck (the cdf
    after every seg-th row and after the last, [b] each)."""
    b, l_pad = t.shape
    k = thr.shape[0]
    dev = t.device
    total = ck[-1] if ck else torch.zeros(b, dtype=torch.float32,
                                          device=dev)
    # ck0[:, c]: the cdf before segment c
    ck0 = torch.stack([torch.zeros_like(total)] + ck, dim=1)
    t_last = (t[:, l_pad - 1] if n_live == l_pad else
              torch.zeros(b, dtype=torch.float32, device=dev))
    idx = torch.full((k, b), l_pad - 1, dtype=torch.int64, device=dev)
    tq = t_last[None].repeat(k, 1)
    evaluated = torch.full((b,), n_live, dtype=torch.int64, device=dev)
    for j in range(k):
        # the first checkpoint above thr_j (the kernel's binary search)
        c = (~(ck0[:, 1:] > thr[j][:, None])).sum(dim=1)
        found = c < len(ck)
        start = c * seg
        end = torch.clamp(start + seg, max=n_live)
        run = torch.gather(ck0, 1, c[:, None])[:, 0]
        got = torch.full((b,), -1, dtype=torch.int64, device=dev)
        tv = torch.zeros(b, dtype=torch.float32, device=dev)
        for s_ in range(seg):
            l = start + s_
            live = found & (l < end)
            tl = torch.gather(t, 1, torch.clamp(l, max=l_pad - 1)[:, None])
            tl = tl[:, 0]
            run = torch.where(live, run + tl, run)
            hit = live & (got < 0) & (run > thr[j])
            got = torch.where(hit, l, got)
            tv = torch.where(hit, tl, tv)
        idx[j] = torch.where(found, got, idx[j])
        tq[j] = torch.where(found, tv, tq[j])
        evaluated = evaluated + torch.where(found, end - start, 0)
    return idx, tq, total, evaluated


def ris_search(gb, pix, looper, tables: ResidentTables, *, k, single_sided,
               has_env=False, seg=None):
    """B7's picks for the gb columns of pixels `pix`: (idx [k, b], tq [k,
    b], total [b], targets evaluated per pixel [b]), as the search kernel
    runs it (`search_streamed`); `seg` defaults to the kernel's
    (`seg_for`)."""
    t, n_live = search_targets(gb, tables, single_sided=single_sided,
                               has_env=has_env)
    n = tables.n_lights
    if seg is None:
        seg = seg_for(n, has_env)
    cdf = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
    for l in range(n_live):
        cdf = cdf + t[:, l]
    thr = thresholds(pix, looper, k, cdf)
    return search_streamed(t, n, n_live, thr, seg)


def reuse_ref(gb, prev_pt, looper, tables: ResidentTables, *, k=4,
              single_sided=True, temporal=True, temporal_clamp=20,
              has_met=True, has_env=False, pix=None, pix0=0, prev_base=0,
              window=fused_di.WINDOW):
    """Plain twin: pt columns for the gb columns of global pixels `pix`
    (whole 1024-pixel tiles in order; when None, the band of gb's pixels
    from `pix0`). prev_pt holds the previous pack from global pixel
    `prev_base`: the whole pack, or a band's with +-`window` halos."""
    dev = gb.device
    if pix is None:
        pix = torch.arange(pix0, pix0 + gb.shape[1], device=dev,
                           dtype=torch.int64)
    out = torch.empty((PT_CH, pix.shape[0]), dtype=torch.float32,
                      device=dev)
    li, wi, dist, w = fused_di.ris_all(
        gb, pix, looper, tables, k=k, single_sided=single_sided,
        has_met=has_met, has_env=has_env)
    chunk = fused_di.chunk_pixels(tables.planes.shape[0])
    for p0 in range(0, pix.shape[0], chunk):
        sl = slice(p0, p0 + chunk)
        g = gb[:, sl]
        w_s = fused_di.shadow_pixels(g, wi[:, sl], dist[sl], w[sl],
                                     tables.planes)
        out[:, sl] = fused_di.temporal_pixels(
            g, li[:, sl], wi[:, sl], dist[sl], w_s, pix[sl], looper,
            prev_pt, k=k, temporal=temporal, temporal_clamp=temporal_clamp,
            prev_base=prev_base, window=window)
    return out


def candidates_cuda(gb, looper, tables: ResidentTables, bvh: BvhTables, *,
                    width, k=4, single_sided=True, has_met=True,
                    has_env=False, stats=False, pix0=0, lib=None,
                    counts=None, _parts=3):
    """Launch `csrc/reuse_bvh.cu` alone: rs [RS_CH, r] (li, wi, dist, W
    after visibility) for gb's r pixels from global pixel `pix0` of a
    frame `width` pixels wide (the whole frame by default), on 2-D pixel
    tiles of the rows they touch. With `stats`, also return the int32 [3,
    r] box and triangle test counts of each shadow ray and the light
    targets each pixel evaluated. `lib`: a library of a stage probe's
    build (`_build.variant_library`) in place of the main one; `counts`:
    an int32 [3, r] buffer passed as the counts (the "fixed-node" probe
    reads the full walk's counts from it). B7 launches its search, then
    its walk; `_parts=1` launches the search alone: rs before visibility
    (the card's checks of the search against its twin)."""
    global launches, search_launches
    r = gb.shape[1]
    dev = gb.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if width <= 0 or pix0 < 0:
        raise ValueError(f"width={width} or pix0={pix0} out of range")
    if _parts not in (1, 3):
        raise ValueError(f"_parts={_parts}")
    lights, psi = tables.light_rows(has_env)
    l_pad = psi.shape[0]
    _check(gb, "gb", (GB_CH, r), dev)
    _check(lights, "lights", psi.shape, dev)
    _check(psi, "psi", psi.shape, dev)
    _check_bvh(bvh, dev)
    rs = torch.empty((RS_CH, r), dtype=torch.float32, device=dev)
    if counts is None and stats:
        counts = torch.empty((3, r), dtype=torch.int32, device=dev)
    p = _build.ptr
    lib = lib or _build.library()
    with _build.on_device(dev):
        err = lib.restir_reuse_bvh(
            p(gb), ctypes.c_uint32(looper & 0xFFFFFFFF), p(lights), p(psi),
            l_pad, tables.n_lights, int(has_env), _parts, p(bvh.rows),
            bvh.size, p(bvh.planes), p(rs), p(counts), r, width, pix0,
            int(single_sided), k, int(has_met), _build.stream_of(dev))
    _build.check(err, "restir_reuse_bvh")
    search_launches += 1
    launches += _parts == 3
    return (rs, counts) if counts is not None else rs


def reuse_cuda(gb, prev_pt, looper, tables: ResidentTables, bvh: BvhTables,
               *, width, k=4, single_sided=True, temporal=True,
               temporal_clamp=20, has_met=True, has_env=False, pix0=0,
               prev_base=0, window=fused_di.WINDOW):
    """Kernel B7, then B1b: pt [PT_CH, r]."""
    rs = candidates_cuda(gb, looper, tables, bvh, k=k,
                         single_sided=single_sided, has_met=has_met,
                         has_env=has_env, width=width, pix0=pix0)
    return fused_di.temporal_cuda(gb, rs, prev_pt, looper, k=k,
                                  temporal=temporal,
                                  temporal_clamp=temporal_clamp, pix0=pix0,
                                  prev_base=prev_base, window=window)


def reuse(gb, prev_pt, looper, tables: ResidentTables, bvh: BvhTables, *,
          width, k=4, single_sided=True, temporal=True, temporal_clamp=20,
          has_met=True, has_env=False, pix0=0, prev_base=0,
          window=fused_di.WINDOW):
    """pt [PT_CH, r] for gb's r pixels from global pixel `pix0` of a frame
    `width` pixels wide (the whole frame by default), merged with the
    previous pack `prev_pt` whose first global pixel is `prev_base`: the
    twin on CPU tensors, the kernels on CUDA tensors."""
    kw = dict(k=k, single_sided=single_sided, temporal=temporal,
              temporal_clamp=temporal_clamp, has_met=has_met,
              has_env=has_env, pix0=pix0, prev_base=prev_base,
              window=window)
    if gb.device.type == "cpu":
        return reuse_ref(gb, prev_pt, looper, tables, **kw)
    if gb.device.type == "cuda":
        return reuse_cuda(gb, prev_pt, looper, tables, bvh, width=width,
                          **kw)
    raise ValueError(f"unsupported device {gb.device}")
