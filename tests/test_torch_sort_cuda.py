"""The ray-order kernels of `csrc/sort.cu` against their twins on a
CUDA card, bit for bit: the coherence key, the one-sweep radix sort
(sizes around the 4,096-key tile, one above the parent design's
4,194,304-key cap; 1 + passes launches a sort), the permuted
gather in both layouts, the scatter, and the copy floor; B13's ray key
and the three-pass sort of its 24-bit keys.

These need nvcc and a GPU; without a card they skip (decided inside the
`cuda_device` fixture). The file imports no JAX, so on a card:

    python -m pytest tests/test_torch_sort_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from restir_tpu_torch.prof import kernels as pk

pytestmark = pytest.mark.cuda

DEAD = pk.DEAD_KEY


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def keys_on(dev, r, seed, hi=2 ** 30):
    g = np.random.default_rng(seed)
    keys = g.integers(0, hi, size=r).astype(np.int32)
    keys[g.random(r) < 0.1] = DEAD
    keys[g.random(r) < 0.01] = 2 ** 30 - 1
    keys[: min(r, 3)] = np.array([DEAD, -1, -(2 ** 31)], np.int32)[:r]
    return torch.tensor(keys, device=dev)


@pytest.mark.parametrize("r,hi", [(1, 2 ** 30), (4095, 2 ** 30),
                                  (4096, 5), (4097, 2 ** 30),
                                  (100003, 2 ** 30), (300000, 1),
                                  (4 * 1024 * 1024 + 1234, 2 ** 30)])
def test_radix_sort_equals_torch_stable_sort(cuda_device, r, hi):
    keys = keys_on(cuda_device, r, r, hi)
    vals, perm = pk.radix_sort(keys)
    want_v, want_p = pk.radix_sort_ref(keys)
    assert torch.equal(perm, want_p) and torch.equal(vals, want_v)
    again = pk.radix_sort(keys)  # reused scratch, same result
    assert torch.equal(again[1], want_p)


def test_radix_sort_launches_one_plus_passes_kernels(cuda_device):
    keys = keys_on(cuda_device, 50000, 1)
    pk.radix_sort(keys)
    torch.cuda.synchronize()
    before = pk.sort_kernel_launches()
    pk.radix_sort(keys)
    torch.cuda.synchronize()
    assert pk.sort_kernel_launches() - before == 1 + pk.SORT_PASSES


def test_key_gather_scatter_copy_equal_twins(cuda_device):
    g = np.random.default_rng(2)
    r = 70001
    x = torch.tensor(g.uniform(-2, 5, size=(r, 3)).astype(np.float32),
                     device=cuda_device)
    y = torch.tensor(g.uniform(-2, 5, size=(r, 3)).astype(np.float32),
                     device=cuda_device)
    live = torch.tensor(g.random(r) < 0.8, device=cuda_device)
    lo, hi = (-1.0, -1.5, 0.0), (4.0, 4.5, 3.0)
    for order in pk.KEY_ORDERS:
        key = pk.coherence_key(x, y, live, lo, hi, order)
        assert torch.equal(key, pk.coherence_key_ref(x, y, live, lo, hi,
                                                     order))
    _, perm = pk.radix_sort(key)
    pl = perm.long()
    pack = torch.tensor(g.normal(size=(9, r)).astype(np.float32),
                        device=cuda_device)
    got = pk.gather_cols(pack, perm)
    assert torch.equal(got, pack.index_select(1, pl))
    assert torch.equal(pk.scatter_cols(got, perm), pack)
    sx, sy, sl = pk.gather_rays(perm, x, y, live)
    assert torch.equal(sx, x[pl]) and torch.equal(sy, y[pl])
    assert torch.equal(sl, live[pl])
    flags = torch.tensor(g.random(r) < 0.3, device=cuda_device)
    want = torch.empty_like(flags)
    want[pl] = flags
    assert torch.equal(pk.scatter_cols(flags, perm), want)
    with pytest.raises(ValueError):  # 9 x 70001 floats: no float4 words
        pk.copy_pack(pack)
    assert torch.equal(pk.copy_pack(pack[:8]), pack[:8])
    big = torch.tensor(g.normal(size=(3, 1 << 20)).astype(np.float32),
                       device=cuda_device)
    assert torch.equal(pk.copy_pack(big), big)


def test_ray_key_and_three_pass_sort_equal_twins(cuda_device):
    """B13's ray key (`ray_order.ray_key`) equals its twin bit for bit on
    seeded rays with zero, tiny, infinite and NaN components and dead
    lanes; its 3-pass sort equals torch.sort (stable), in the launches it
    counts."""
    from restir_tpu_torch.ops.kernels import ray_order as ro

    g = np.random.default_rng(24)
    r = 50001
    o = g.uniform(-2, 5, size=(r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    d[0::13, 0] = 0.0
    d[1::13, 1] = -0.0
    d[2::13, 2] = 1e-13
    d[3::13, 0] = -1e-13
    d[4::13, 1] = np.inf
    o[5::13, 2] = -np.inf
    d[6::13, 2] = np.nan
    o, d = (torch.tensor(t, device=cuda_device) for t in (o, d))
    live = torch.tensor(g.random(r) < 0.8, device=cuda_device)
    rows = torch.tensor(np.array([[-1.0, -1.5, 0.0, 0.0, 4.0, 4.5, 3.0, 0.0]],
                                 np.float32), device=cuda_device)
    for active in (None, live):
        key = ro.ray_key(o, d, active, rows)
        assert torch.equal(key, ro.ray_key_ref(o, d, active, rows))
    passes = ro.RAY_SORT_PASSES
    before = ro.sort_kernel_launches()
    vals, perm = ro.radix_sort(key, passes)
    torch.cuda.synchronize()
    assert ro.sort_kernel_launches() - before == 1 + passes
    want_v, want_p = ro.radix_sort_ref(key)
    assert torch.equal(vals, want_v) and torch.equal(perm, want_p)
