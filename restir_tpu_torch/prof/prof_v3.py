"""A 90-round masked triplet multiply-add chain (a = m ? a c_i + b : a)
over an 8-channel pixel pack at 1920x1080, in three layouts
(`csrc/prof/mem.cu`): channel-major SoA (the TPU's), float3 AoS and
float4, each equal to the plain twin bit for bit.

Port of the TPU probe prof/prof_v3.py (the pallas_call at :92): the GI
chain's triplets as three 1-D ops, one stacked op, or stacked with the
restacking tax.

    python -m restir_tpu_torch.prof v3
"""

from __future__ import annotations

import numpy as np
import torch

from . import _timing
from . import kernels as pk

R = 1920 * 1080


def pack(r, device, seed=0):
    """[8, r]: a (3) and b (3) uniform in [0, 1), the mask channel, 0."""
    g = np.random.default_rng(seed)
    p = g.uniform(0.0, 1.0, size=(8, r)).astype(np.float32)
    p[7] = 0.0
    return torch.as_tensor(p, device=device).contiguous()


def run(device="cuda", small=False):
    r = 4096 if small else R
    p = pack(r, device)
    want = pk.chain_ref(p)
    for layout in pk.CHAIN_LAYOUTS:
        if not torch.equal(pk.chain(p, layout), want):
            raise RuntimeError(f"v3: the {layout} chain differs from its "
                               "twin")
    if _timing.on_card(device):  # the kernels alone, inputs laid out
        laid = {c: pk.chain_inputs(p, c) for c in pk.CHAIN_LAYOUTS}
        calls = {c: (lambda c=c: pk.chain_laid(laid[c], c))
                 for c in pk.CHAIN_LAYOUTS}
    else:
        calls = {c: (lambda c=c: pk.chain(p, c)) for c in pk.CHAIN_LAYOUTS}
    times = _timing.interleaved(calls, device, rounds=2)
    return [_timing.times_row("v3", layout, ts, f"{r} pixels, 90 rounds")
            for layout, ts in times.items()]
