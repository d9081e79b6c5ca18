"""The port's Sobol sampler is bit-exact with `restir_tpu.utils.sobol`.

`restir_tpu_torch.utils.sobol.sobol4` against the JAX `sobol4` on random
32-bit pixel indices (half of them >= 2^31, numpy seeded), at sample
indices across the uint32 range, and `rng.draw4`'s dispatch on the
sampler name, as the JAX `draw4` dispatches.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from restir_tpu.utils import rng as jrng
from restir_tpu.utils import sobol as jsobol
from restir_tpu_torch.utils import rng as trng
from restir_tpu_torch.utils import sobol as tsobol

N = 1 << 14


def _pixels(seed):
    g = np.random.default_rng(seed)
    a = g.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    a[: N // 2] |= np.uint32(1 << 31)
    return a


@pytest.mark.parametrize("index,ctr,salt", [
    (0, 0, jrng.SALT_CAMERA), (5, 3, jrng.SALT_PT), (123456789, 1,
                                                     jrng.SALT_RESTIR),
    (0xFFFFFFF0, 7, jrng.SALT_GI)])
def test_sobol4_matches_jax(index, ctr, salt):
    pix = _pixels(index & 0xFFFF)
    want = jsobol.sobol4(jnp.asarray(pix), jnp.uint32(index), ctr, salt)
    got = tsobol.sobol4(torch.as_tensor(pix.astype(np.int64)), index, ctr,
                        salt)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        assert np.array_equal(np.asarray(w), g.numpy())
        assert 0.0 <= float(g.min()) and float(g.max()) < 1.0


def test_sobol_bits_match_jax():
    idx = _pixels(11)
    for dim in range(4):
        want = np.asarray(jsobol._sobol_bits(jnp.asarray(idx), dim))
        got = tsobol._sobol_bits(torch.as_tensor(idx.astype(np.int64)), dim)
        assert np.array_equal(want, got.numpy().astype(np.uint32))


@pytest.mark.parametrize("sampler", ["sobol", "pcg4d"])
def test_draw4_dispatch_matches_jax(sampler):
    pix = np.arange(4096, dtype=np.uint32)
    want = jrng.draw4(sampler, jnp.asarray(pix), jnp.uint32(9), 2,
                      jrng.SALT_PT)
    got = trng.draw4(sampler, torch.as_tensor(pix.astype(np.int64)), 9, 2,
                     trng.SALT_PT)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
