"""Counter-based RNG, bit-exact with `restir_tpu.utils.rng`.

Every draw is `pcg4d(pixel_index, looper, counter, salt)`, the same
streams, counters and salts as the JAX package, so the port and the
reference consume identical random numbers lane for lane.

uint32 arithmetic on torch runs in int64 with an explicit 32-bit mask.
A u32 x u32 product can reach 2^64 and overflow int64, so `_mul32`
splits one factor into 16-bit halves: every partial product stays below
2^50 and the masked sum is the exact low 32 bits of the true product.
The CUDA kernels use native `uint32_t` instead.
"""

from __future__ import annotations

import torch

SALT_CAMERA = 0x01
SALT_RESTIR = 0x02
SALT_PT = 0x03
SALT_GI = 0x04
SALT_DEBUG = 0x7F

_MASK = 0xFFFFFFFF


def _u32(v, device=None) -> torch.Tensor:
    """Integer tensor/scalar -> int64 tensor holding the uint32 value."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, dtype=torch.int64, device=device)
    return v.to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64."""
    a_lo = a & 0xFFFF
    a_hi = a >> 16
    return (a_lo * b + ((a_hi * b) & 0xFFFF) * 65536) & _MASK


def utilhash(a) -> torch.Tensor:
    """32-bit avalanche hash (restir_tpu.utils.rng.utilhash)."""
    a = _u32(a)
    a = ((a + 0x7ED55D16) + (a << 12)) & _MASK
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _MASK
    a = ((a + 0x165667B1) + (a << 5)) & _MASK
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _MASK
    a = ((a + 0xFD7046C5) + (a << 3)) & _MASK
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _MASK
    return a


def pcg4d(x, y, z, w):
    """PCG4D hash: 4 x uint32 -> 4 x uint32 (as int64 tensors)."""
    dev = next((t.device for t in (x, y, z, w)
                if isinstance(t, torch.Tensor)), None)
    vx, vy, vz, vw = (
        (_mul32(_u32(v, dev), 1664525) + 1013904223) & _MASK
        for v in (x, y, z, w)
    )
    vx, vy, vz, vw = torch.broadcast_tensors(vx, vy, vz, vw)

    vx = (vx + _mul32(vy, vw)) & _MASK
    vy = (vy + _mul32(vz, vx)) & _MASK
    vz = (vz + _mul32(vx, vy)) & _MASK
    vw = (vw + _mul32(vy, vz)) & _MASK

    vx = vx ^ (vx >> 16)
    vy = vy ^ (vy >> 16)
    vz = vz ^ (vz >> 16)
    vw = vw ^ (vw >> 16)

    vx = (vx + _mul32(vy, vw)) & _MASK
    vy = (vy + _mul32(vz, vx)) & _MASK
    vz = (vz + _mul32(vx, vy)) & _MASK
    vw = (vw + _mul32(vy, vz)) & _MASK
    return vx, vy, vz, vw


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform4(pixel_index, looper, ctr, salt=SALT_CAMERA):
    a, b, c, d = pcg4d(pixel_index, looper, ctr, salt)
    return _unit(a), _unit(b), _unit(c), _unit(d)


def uniform1(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[0]


def uniform2(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[:2]


def uniform3(pixel_index, looper, ctr, salt=SALT_CAMERA):
    return uniform4(pixel_index, looper, ctr, salt)[:3]


def draw4(sampler: str, pixel_index, looper, ctr, salt=SALT_CAMERA):
    """uniform4 behind the config's sampler choice (rng.draw4): "pcg4d",
    or "sobol", Owen-scrambled Sobol points (`utils/sobol.py`) with
    `looper` as the sample index."""
    if sampler == "sobol":
        from .sobol import sobol4

        return sobol4(pixel_index, looper, ctr, salt)
    return uniform4(pixel_index, looper, ctr, salt)
