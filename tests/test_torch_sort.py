"""The ray-order kernels of `csrc/sort.cu` on the CPU: the one-sweep
radix sort's pass plan and the permuted gather / scatter's twins.

- `sort_plan`, a numpy rendition of the sort's passes (digit counts of
  every pass from one read of the keys; per pass, each tile's ranks from
  its warps' rounds and its place of each digit from a look-back over the
  tiles before it), gives the permutation of np.argsort(kind="stable")
  and of jnp.argsort(stable=True) (the JAX probe prof/prof_wavefront.py's
  sort), with look-backs that stop at once or walk back to the first
  tile, on keys that hold the dead key 0x7FFFFFFF, 2^30 - 1 and
  negatives, at sizes that are not a multiple of the tile, and once above
  4,194,304 keys (the parent design's cap). Three passes of 10 bits would
  not reach bit 30 and put dead lanes among live ones; three of 11 would.
- the wrappers' twins on CPU tensors: the sort against torch.sort
  (stable), the gather in both layouts ([C, R] pack and B13's [R, 3] /
  [R] inputs) and the scatter against numpy, the scatter inverting the
  gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _sort_plan import sort_plan
from restir_tpu_torch.prof import kernels as pk

DEAD = pk.DEAD_KEY


def ray_keys(r, seed, hi=2 ** 30):
    """Keys with ties, the dead key, 2^30 - 1 and a few negatives."""
    g = np.random.default_rng(seed)
    keys = g.integers(0, hi, size=r).astype(np.int32)
    keys[g.random(r) < 0.1] = DEAD
    keys[g.random(r) < 0.01] = 2 ** 30 - 1
    edge = np.array([DEAD, 2 ** 30 - 1, 0, -1, -(2 ** 31), DEAD, 2 ** 30 - 1],
                    np.int32)
    keys[:7] = edge[:r]
    return keys


@pytest.mark.parametrize("ready", [0.0, 1.0])
@pytest.mark.parametrize("r,hi,tile", [
    (1, 2 ** 30, (8, 16)), (5000, 2 ** 30, (8, 16)), (4097, 37, (8, 16)),
    (3001, 2 ** 30, (2, 4)), (700, 3, (1, 1))])
def test_sort_plan_is_a_stable_sort(ready, r, hi, tile):
    """ready 0: every look-back walks to tile 0; 1: it stops at the tile
    before."""
    keys = ray_keys(r, r + int(8 * ready), hi)
    want = np.argsort(keys, kind="stable")
    got_k, got_p = sort_plan(keys, pk.SORT_BITS, warps=tile[0],
                             rounds=tile[1], ready=ready)
    assert np.array_equal(got_p, want)
    assert np.array_equal(got_k, keys[want])
    assert np.array_equal(np.asarray(jnp.argsort(jnp.asarray(keys),
                                                 stable=True)), want)


def test_sort_plan_above_the_old_cap():
    """4,194,304 + 1,234 keys (not a multiple of the 4,096-key tile) at
    the wrapper's digit width, as hall keys at 3840x2160 would be."""
    r = 4 * 1024 * 1024 + 1234
    g = np.random.default_rng(3)
    keys = g.integers(0, 2 ** 30, size=r).astype(np.int32)
    keys[g.random(r) < 0.2] = DEAD
    keys[::977] = 2 ** 30 - 1
    want = np.argsort(keys, kind="stable")
    got_k, got_p = sort_plan(keys, pk.SORT_BITS)
    assert np.array_equal(got_p, want) and np.array_equal(got_k, keys[want])
    assert np.array_equal(np.asarray(jnp.argsort(jnp.asarray(keys),
                                                 stable=True)), want)


def test_three_ten_bit_passes_miss_bit_30():
    """2^30 - 1 and the dead key agree in bits 0-29: 3 passes of 10 bits
    leave them in input order, so a dead lane sorts among live ones."""
    keys = np.array([DEAD, 2 ** 30 - 1, 5, DEAD, 2 ** 30 - 1], np.int32)
    want = np.argsort(keys, kind="stable")
    _, p10 = sort_plan(keys, 10, passes=3, warps=1, rounds=1)
    assert not np.array_equal(p10, want)
    assert pk.SORT_PASSES * pk.SORT_BITS > 30
    assert np.array_equal(sort_plan(keys, pk.SORT_BITS)[1], want)
    assert np.array_equal(sort_plan(keys, 11)[1], want)


def test_sort_twin_is_torch_stable_sort():
    keys = ray_keys(9000, 4)
    want = np.argsort(keys, kind="stable")
    vals, perm = pk.radix_sort(torch.tensor(keys))
    assert perm.dtype == torch.int32
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(vals.numpy(), keys[want])


def test_gather_and_scatter_twins_match_numpy():
    g = np.random.default_rng(9)
    r = 1537
    perm = g.permutation(r).astype(np.int32)
    tp = torch.tensor(perm)
    pack = g.normal(size=(9, r)).astype(np.float32)
    got = pk.gather_cols(torch.tensor(pack), tp)
    assert np.array_equal(got.numpy(), pack[:, perm])
    back = pk.scatter_cols(got, tp)
    assert np.array_equal(back.numpy(), pack)  # the scatter inverts it
    pos = g.normal(size=(r, 3)).astype(np.float32)
    target = g.normal(size=(r, 3)).astype(np.float32)
    live = g.random(r) < 0.7
    x, y, sl = pk.gather_rays(tp, torch.tensor(pos), torch.tensor(target),
                              torch.tensor(live))
    assert x.shape == (r, 3) and sl.dtype == torch.bool
    assert np.array_equal(x.numpy(), pos[perm])
    assert np.array_equal(y.numpy(), target[perm])
    assert np.array_equal(sl.numpy(), live[perm])
    flags = g.random(r) < 0.4
    out = pk.scatter_cols(torch.tensor(flags), tp).numpy()
    want = np.empty_like(flags)
    want[perm] = flags
    assert np.array_equal(out, want)
    assert np.array_equal(out[perm], flags)
    ints = g.integers(-5, 5, size=(2, r)).astype(np.int32)
    want = np.empty_like(ints)
    want[:, perm] = ints
    assert np.array_equal(pk.scatter_cols(torch.tensor(ints), tp).numpy(),
                          want)
