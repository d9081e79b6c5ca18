"""The one-sweep radix sort of `restir_tpu_torch/csrc/sort.cu` as a
numpy pass plan, for the tests (`test_torch_sort.py`, `test_torch_prof.py`).
"""

import numpy as np


def sort_plan(keys, bits, passes=None, warps=8, rounds=16, ready=0.5,
              seed=0):
    """The kernels' pass plan in numpy: (sorted keys, int64 permutation)
    of int32 keys [R]. Digits of `bits` bits of the key with its sign bit
    flipped, `passes` of them (all 32 bits by default); every pass's
    digit counts from one read of the keys, each digit's first place
    their exclusive scan. Per pass, tiles of warps x rounds x 32 keys: a
    key's rank in its tile is the keys of its digit before it in the tile
    (warps, rounds and lanes in order, as `__match_any_sync` ranks them in
    a round), and the tile's place of each digit the look-back: the
    aggregates of the tiles before it, nearest first, until one whose
    inclusive prefix is published (each is, with probability `ready`;
    tile 0 always). A look-back word's count must fit its 30 bits. Loops
    over a tile's rounds and the look-back's steps; every key at once."""
    lanes = 32
    radix = 1 << bits
    passes = passes or -(-32 // bits)
    u = np.ascontiguousarray(keys, dtype=np.int32).view(np.uint32)
    u = u ^ np.uint32(0x80000000)
    r = u.size
    assert 0 < r < 2 ** 30
    tile = warps * rounds * lanes
    nt = -(-r // tile)
    g = np.random.default_rng(seed)
    first = []
    for p in range(passes):  # the histogram launch
        d = (u >> np.uint32(bits * p)) & np.uint32(radix - 1)
        c = np.bincount(d, minlength=radix)
        first.append(np.cumsum(c) - c)
    kin, vin = u.copy(), np.arange(r, dtype=np.int64)
    tiles = np.arange(nt)
    below = np.tri(lanes, k=-1, dtype=bool)  # [lane, lane']: lane' < lane
    for p in range(passes):
        d = ((kin >> np.uint32(bits * p)) & np.uint32(radix - 1)).astype(
            np.int64)
        dt = np.concatenate([d, np.full(nt * tile - r, radix)]).reshape(
            nt, tile)  # digit `radix`: past the last key
        rank = np.empty((nt, tile), np.int64)
        run = np.zeros((nt, radix + 1), np.int64)  # placed so far a digit
        for q in range(tile // lanes):
            dq = dt[:, q * lanes:(q + 1) * lanes]
            peers = (dq[:, :, None] == dq[:, None, :]) & below
            rank[:, q * lanes:(q + 1) * lanes] = (
                run[tiles[:, None], dq] + peers.sum(2))
            np.add.at(run, (np.repeat(tiles, lanes), dq.ravel()), 1)
        count = run[:, :radix]  # each tile's aggregate
        incl = np.cumsum(count, 0)  # each tile's inclusive prefix
        assert incl[-1].max() < 2 ** 30
        published = g.random(nt) < ready
        published[0] = True
        excl = np.zeros((nt, radix), np.int64)
        looking = tiles > 0
        back = 1
        while looking.any():
            q = np.where(looking, tiles - back, 0)
            stop = looking & published[q]
            excl[stop] += incl[q[stop]]
            more = looking & ~published[q]
            excl[more] += count[q[more]]
            looking = more
            back += 1
        t_of = np.arange(r) // tile
        dk = dt.ravel()[:r]
        dst = first[p][dk] + excl[t_of, dk] + rank.ravel()[:r]
        assert np.array_equal(np.bincount(dst, minlength=r), np.ones(r))
        kout, vout = np.empty_like(kin), np.empty_like(vin)
        kout[dst], vout[dst] = kin, vin
        kin, vin = kout, vout
    return (kin ^ np.uint32(0x80000000)).view(np.int32), vin
