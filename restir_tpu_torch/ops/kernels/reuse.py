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
once (`csrc/reuse_bvh.cu`): pass 1 sums the light targets in row order
and keeps the running cdf after every S-th row (the kernel picks S for
the card, `seg_cuda`; `seg_for` is its host mirror: 8 or 16 on an H100),
then each pick re-scans only the segment whose checkpoint first exceeds
its threshold. The adds are the full two-pass scan's, in its order, so
the picks are its picks bit for bit. `ris_search` / `search_seg` and
`search_full` mirror the two on CPU tensors (sequential float32 adds
over rows, vectorised over pixels) for the tests.

Light tables whose staged build would pass a block's shared memory
(`SMEM_MAX`: more than about 2,400 area lights) take B7's streamed build:
pass 1 reads the area rows through a double buffer of `CHUNK_ROWS` rows,
S grows past `SEGS` until the checkpoints fit (`seg_for(...,
streamed=True)`), and each pick re-scans its segment from device memory.
It picks the same rows bit for bit. The wrapper picks the build from the
table size (`streamed_for`); nothing else chooses it.
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
    SMEM_MAX,
    _check,
    _fma32,
    light_target_rows,
    ris_frame,
)
from .gbuffer import BLOCK, _check_bvh
from .tables import BvhTables, ResidentTables

launches = 0  # launches of reuse_bvh's staged build
streamed_launches = 0  # launches of its streamed build

N_ENV = ENV_TH * ENV_TW  # env-tile light rows after the area lights
# Host mirror of csrc/reuse_bvh.cu's b7_seg, for the CPU search and the
# tests: kSegs, kChunkRows, the blocks per SM of its launch bounds
# (kBlocksPerSm, kBlocksPerSmEnv) and an H100 SM's shared memory. The
# tests hold the first three against the source and the mirror against
# the kernel's S.
SEGS = (8, 16, 32)  # light rows per cdf checkpoint of the staged build
CHUNK_ROWS = 64  # area rows a chunk of the streamed build's pass 1
BLOCKS_PER_SM = {False: 4, True: 3}  # by env build
SMEM_SM = 233472  # shared memory of one Hopper SM (bytes)
SMEM_BLOCK_RESERVED = 1024  # shared memory the system keeps per block


def smem_bytes(n_area: int, has_env: bool, n_live: int, seg: int,
               streamed: bool = False) -> int:
    """B7's shared memory per block: the area lights' psi rows (64 B;
    streamed: the double buffer of 2 x CHUNK_ROWS rows), the env tiles'
    compact rows (d_tile, radius | luminance: 20 B) and one cdf
    checkpoint per `seg` rows for each of the BLOCK threads."""
    n_env = N_ENV if has_env else 0
    rows = 2 * CHUNK_ROWS if streamed else n_area
    return rows * 64 + n_env * 20 + -(-n_live // seg) * BLOCK * 4


def seg_for(n_area: int, has_env: bool, streamed: bool = False) -> int:
    """B7's checkpoint spacing on an H100 (the host mirror of the
    kernel's b7_seg): the smallest whose checkpoints still leave room in
    shared memory for the blocks per SM its launch bounds ask for. The
    staged build takes one of SEGS (each pick re-scans that many rows),
    else the largest: 8 on 128 light rows, 16 on 640 (128 area lights and
    the env tiles). The streamed build doubles S from SEGS[0] until it
    fits: 64 on 2,450 area rows, 256 on 10,000."""
    n_live = n_area + (N_ENV if has_env else 0)
    cap = SMEM_SM // BLOCKS_PER_SM[has_env] - SMEM_BLOCK_RESERVED
    if streamed:
        seg = SEGS[0]
        while (seg < n_live and
               smem_bytes(n_area, has_env, n_live, seg, True) > cap):
            seg *= 2
        return seg
    for seg in SEGS:
        if smem_bytes(n_area, has_env, n_live, seg) <= cap:
            return seg
    return SEGS[-1]


def streamed_for(n_area: int, has_env: bool, seg: int | None = None) -> bool:
    """Whether B7 takes its streamed build: when the staged build, at its
    spacing `seg` (by default the host mirror's), would pass SMEM_MAX."""
    n_live = n_area + (N_ENV if has_env else 0)
    if seg is None:
        seg = seg_for(n_area, has_env)
    return smem_bytes(n_area, has_env, n_live, seg) > SMEM_MAX


def seg_cuda(n_area: int, has_env: bool, device=None,
             streamed: bool = False) -> int:
    """The checkpoint spacing B7's build (staged, or `streamed`) takes on
    `device` (the current CUDA device when None; its b7_seg)."""
    lib = _build.library()
    with _build.on_device(device):
        seg = lib.restir_reuse_bvh_seg(n_area, int(has_env), int(streamed))
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
    b, l_pad = t.shape
    k = thr.shape[0]
    dev = t.device
    cdf = torch.zeros(b, dtype=torch.float32, device=dev)
    ck = []
    for l in range(n_live):
        cdf = cdf + t[:, l]
        if (l + 1) % seg == 0 or l == n_live - 1:
            ck.append(cdf)
    total = cdf
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
    b], total [b], targets evaluated per pixel [b]); `seg` defaults to the
    kernel's (`seg_for` of the build `streamed_for` picks)."""
    t, n_live = search_targets(gb, tables, single_sided=single_sided,
                               has_env=has_env)
    if seg is None:
        n = tables.n_lights
        seg = seg_for(n, has_env, streamed_for(n, has_env))
    cdf = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
    for l in range(n_live):
        cdf = cdf + t[:, l]
    return search_seg(t, n_live, thresholds(pix, looper, k, cdf), seg)


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
                    counts=None, _streamed=None):
    """Launch `csrc/reuse_bvh.cu` alone: rs [RS_CH, r] (li, wi, dist, W
    after visibility) for gb's r pixels from global pixel `pix0` of a
    frame `width` pixels wide (the whole frame by default), on 2-D pixel
    tiles of the rows they touch. With `stats`, also return the int32 [3,
    r] box and triangle test counts of each shadow ray and the light
    targets each pixel evaluated. `lib`: a library of a stage probe's
    build (`_build.variant_library`) in place of the main one; `counts`:
    an int32 [3, r] buffer passed as the counts (the "fixed-node" probe
    reads the full walk's counts from it). The build follows the table
    size (`streamed_for`); `_streamed` forces one (tests and the card's
    checks)."""
    global launches, streamed_launches
    r = gb.shape[1]
    dev = gb.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if width <= 0 or pix0 < 0:
        raise ValueError(f"width={width} or pix0={pix0} out of range")
    lights, psi = tables.light_rows(has_env)
    l_pad = psi.shape[0]
    streamed = _streamed
    if streamed is None:
        streamed = streamed_for(tables.n_lights, has_env,
                                seg_cuda(tables.n_lights, has_env, dev))
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
            l_pad, tables.n_lights, int(has_env), int(streamed),
            p(bvh.rows), bvh.size, p(bvh.planes), p(rs), p(counts), r,
            width, pix0, int(single_sided), k, int(has_met),
            _build.stream_of(dev))
    _build.check(err, "restir_reuse_bvh")
    if streamed:
        streamed_launches += 1
    else:
        launches += 1
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
