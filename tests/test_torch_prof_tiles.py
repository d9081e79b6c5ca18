"""The host side of the any hit and table gather probe kernels on the
CPU (`restir_tpu_torch/prof/kernels.py`, `csrc/prof/anyhit.cu`,
`csrc/prof/mem.cu`):

- the any hit's twins (FP32 dots; TF32 pieces for the tensor-core
  forms) against the JAX package's occlusion test
  (`restir_tpu.ops.intersect_bf`) on seeded random segments of the
  probe's kind (`prof_fma.random_rays`: origins in the headline scene's
  box, limits 1-30), within the reference's primitive gate;
- the TF32 pieces the tensor-core forms multiply: each an exact TF32
  value, and the products `split_dot` sums built from them;
- a numpy model of the shared table gather's lanes: the grid its
  launcher sizes (the blocks the card holds at once, no more than the
  quads need, at least one), grid-stride quads of four lanes a thread
  read in a turned order, and block 0's scalar tail, covers every lane
  of R in {1, 3, 4093, 1920 x 1088} exactly once, and each warp's reads
  of one step fall in 32 banks under the probe's index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restir_tpu.ops import intersect_bf as jbf
from restir_tpu_torch import convert
from restir_tpu_torch.ops import intersect as tix
from restir_tpu_torch.ops import intersect_bf
from restir_tpu_torch.prof import kernels as pk
from restir_tpu_torch.prof import prof_fma
from restir_tpu_torch.scene.procedural import many_light_scene

GATE = prof_fma.GATE


@pytest.fixture(scope="module")
def headline():
    arrays, _ = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(arrays, "cpu")
    xform = tix.traversal_arrays(scene, "brute").tri_xform
    return xform, arrays.bounds_lo[0], arrays.bounds_hi[0]


@pytest.mark.parametrize("seed", [5, 11])
def test_anyhit_twins_match_jax_on_random_segments(headline, seed):
    xform, lo, hi = headline
    r = 3000
    ray = prof_fma.random_rays(lo, hi, r, "cpu", seed=seed)
    x = ray[0:3].T.contiguous()
    y = (x + ray[3:6].T * ray[6][:, None]).contiguous()
    o, d, limit = intersect_bf.occlusion_ray(x, y)
    rays = torch.cat([o.T, d.T, limit[None], torch.zeros(1, r)]).contiguous()
    planes = pk.plane_rows(xform, prof_fma.N_PAD)
    want = np.asarray(jbf.test_occlusion_bf(jnp.asarray(xform.numpy()),
                                            jnp.asarray(x.numpy()),
                                            jnp.asarray(y.numpy())))
    assert 0.05 < want.mean() < 0.95
    for form in pk.ANYHIT_FORMS:
        got = pk.anyhit(rays, planes, form).numpy()
        assert (got != want).mean() <= GATE, form


def test_tf32_pieces_rebuild_split_dot(headline):
    """Each piece is a TF32 value (13 low bits clear), so the product of
    two is exact in float32 (what the tensor cores multiply); the
    products, summed as `split_dot` sums them, are what it returns."""
    xform, lo, hi = headline
    planes = pk.plane_rows(xform, prof_fma.N_PAD)
    ray = prof_fma.random_rays(lo, hi, 257, "cpu", seed=2)
    a = torch.cat([ray[0:3], torch.ones_like(ray[:1])]).T.contiguous()
    for x in (planes[:, 0:4], planes[:, 4:8], planes[:, 8:12], a):
        pieces = pk.tf32_split(x.contiguous())
        for piece in pieces:
            assert not bool((piece.view(torch.int32) & 0x1FFF).any())
        hi_, mid, lo_ = pieces
        # hi + mid holds 22 bits, hi + mid + lo every bit of x
        assert torch.equal(hi_ + mid + lo_, x)
        assert bool(((hi_ + mid - x).abs() <= x.abs() * 2.0 ** -21).all())
    b = planes[:, 4:8]
    ah, am, al = pk.tf32_split(a)
    bh, bm, bl = pk.tf32_split(b)
    three = am @ bh.T + ah @ bm.T + ah @ bh.T
    assert torch.equal(pk.split_dot(a, b, 3), three)
    six = (al @ bh.T + ah @ bl.T + am @ bm.T) + (am @ bh.T + ah @ bm.T)
    assert torch.equal(pk.split_dot(a, b, 6), six + ah @ bh.T)
    for p, q in ((ah, bh), (am, bh), (ah, bm), (al, bh), (ah, bl), (am, bm)):
        exact = p[:, None, :].double() * q[None, :, :].double()
        assert torch.equal((p[:, None, :] * q[None, :, :]).double(), exact)


THREADS = 1024  # the shared gather's block (csrc/prof/mem.cu kGatherThreads)


def gather_blocks(r, resident, threads=THREADS):
    """The shared gather's grid (restir_prof_table_gather): as many blocks
    as the card holds at once (`resident`), no more than R // 4 quads
    need (one a thread), at least 1 (the R % 4 tail is block 0's)."""
    return max(1, min(resident, -(-(r // 4) // threads)))


def gather_model(r, blocks, threads=THREADS):
    """(times each lane is written, the lanes the grid's threads read at
    each step, thread by thread) for the shared gather: thread q of the
    grid takes quads q, q + stride, ... (lanes 4 quad .. 4 quad + 3,
    read in the turned order 4 quad + (s + (q % threads) // 8 % 4) % 4
    at step s); block 0's threads write the r % 4 tail lanes."""
    quads = r // 4
    stride = blocks * threads
    seen = np.zeros(r, np.int64)
    reads = []
    for start in range(0, quads, stride):
        q = np.arange(start, min(start + stride, quads))
        turn = ((q % threads) >> 3) & 3
        for s in range(4):
            lanes = 4 * q + (s + turn) % 4
            np.add.at(seen, lanes, 1)
            reads.append(lanes)
    tail = 4 * quads + np.arange(threads)
    np.add.at(seen, tail[tail < r], 1)
    return seen, reads


@pytest.mark.parametrize("r", [1, 3, 4093, 1920 * 1088])
@pytest.mark.parametrize("resident", [1, 264, 100000])
def test_gather_lanes_cover_every_lane_once(r, resident):
    blocks = gather_blocks(r, resident)
    assert 1 <= blocks <= resident
    assert blocks == 1 or (blocks - 1) * THREADS < r // 4
    seen, reads = gather_model(r, blocks)
    assert seen.min() == 1 and seen.max() == 1


@pytest.mark.parametrize("k", [1024, 8192])
def test_gather_warp_reads_fall_in_32_banks(k):
    r = 1920 * 1088
    idx = pk.gather_index(r, k, "cpu").numpy()
    _, reads = gather_model(r, gather_blocks(r, 264))
    for lanes in reads[:8]:
        full = lanes[: len(lanes) // 32 * 32].reshape(-1, 32)
        banks = idx[full] % 32
        assert all(len(set(w)) == 32 for w in banks)
    # reading the four lanes in order would put 4 threads on a bank
    q = np.arange(32)
    assert len(set(idx[4 * q] % 32)) == 8
