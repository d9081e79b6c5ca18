"""Owen-scrambled Sobol sampling, bit-exact with `restir_tpu.utils.sobol`.

The reference's optional Sobol sampler (SAMPLER_USE_SOBOL, sampler.h:13-32)
read a precomputed scrambled table; here, as in the JAX package, the
points are evaluated from direction numbers (4 dimensions: van der
Corput, then the Joe-Kuo polynomials of degree 1, 2 and 3) and
Owen-scrambled with the Laine-Karras hash in reversed-bit space (Burley,
"Practical Hash-based Owen Scrambling", JCGT 2020). `sobol4(pixel,
index, ctr, salt)` shuffles the sample index per pixel and seeds each
dimension's scramble from pcg4d(pixel, ctr, salt, 0x50B07).

uint32 arithmetic runs in int64 with a 32-bit mask, as in `utils/rng.py`
(`_mul32` keeps every product exact).
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .rng import _MASK, _mul32, _u32


def _sobol_direction_table() -> np.ndarray:
    """Direction numbers for 4 dimensions x 32 bits (dim 0 = van der
    Corput; dims 1-3 from Joe-Kuo primitive polynomials)."""
    v = np.zeros((4, 32), np.uint32)
    for b in range(32):
        v[0, b] = np.uint32(1) << np.uint32(31 - b)
    # Joe-Kuo: (degree s, polynomial a, initial m values)
    params = [(1, 0, [1]), (2, 1, [1, 3]), (3, 1, [1, 3, 1])]
    for dim, (s, a, m_init) in enumerate(params, start=1):
        m = list(m_init)
        for i in range(s, 32):
            newm = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    newm ^= m[i - k] << k
            m.append(newm)
        for b in range(32):
            v[dim, b] = np.uint32(m[b]) << np.uint32(31 - b)
    return v


_DIRS = [[int(x) for x in row] for row in _sobol_direction_table()]


def _sobol_bits(index: torch.Tensor, dim: int) -> torch.Tensor:
    """32-bit Sobol value of `index` (uint32 in int64) in dimension dim."""
    out = torch.zeros_like(index)
    for b, v in enumerate(_DIRS[dim]):
        out = out ^ torch.where(((index >> b) & 1) != 0, v, 0)
    return out


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _MASK


def _owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras hash applied in reversed-bit space (Burley 2020)."""
    x = (_reverse_bits(x) + seed) & _MASK
    for k in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, k)
    return _reverse_bits(x)


def sobol4(pixel_index, sample_index, ctr, salt=rng.SALT_CAMERA):
    """Four Owen-scrambled Sobol values in [0, 1) (float32): the sample
    index Owen-shuffled per pixel, each dimension scrambled with its own
    pcg4d seed."""
    s1, s2, s3, s4 = rng.pcg4d(pixel_index, ctr, salt, 0x50B07)
    index = torch.broadcast_to(_u32(sample_index, s1.device), s1.shape)
    shuffled = _owen_scramble(index, s1 ^ s2)
    return tuple(rng._unit(_owen_scramble(_sobol_bits(shuffled, dim), seed))
                 for dim, seed in enumerate((s1, s2, s3, s4)))
