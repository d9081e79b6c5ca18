"""Table gathers at R = 1920 x 1088 with index (i * 7919) % K from a
float32 table of K = 1024 and 8192 entries, three ways
(`csrc/prof/mem.cu`): from shared memory, through the read-only cache
(__ldg) and from a texture object, against index_select (bit for bit).

Port of the TPU probe prof/prof_gather.py: `take_along_axis` on tables
in VMEM (the pallas_call at :43), the texture fetch candidates.

    python -m restir_tpu_torch.prof gather
"""

from __future__ import annotations

import torch

from . import _timing
from . import kernels as pk

R = 1920 * 1088
SIZES = (1024, 8192)


def run(device="cuda", small=False):
    r = 4096 if small else R
    rows = []
    for k in SIZES:
        table = torch.arange(k, dtype=torch.float32, device=device) * 0.5
        idx = pk.gather_index(r, k, device)
        want = table.index_select(0, idx.long())
        tex = pk.texture(table) if _timing.on_card(device) else None
        try:
            for where in pk.GATHER_WHERE:
                got = pk.table_gather(table, idx, where, tex=tex)
                if not torch.equal(got, want):
                    raise RuntimeError(f"gather: {where} differs from "
                                       "index_select")
            calls = {w: (lambda w=w: pk.table_gather(table, idx, w, tex=tex))
                     for w in pk.GATHER_WHERE}
            calls["index_select"] = lambda: table.index_select(0, idx.long())
            times = _timing.interleaved(calls, device, rounds=2)
        finally:
            if tex is not None:
                _timing.sync(device)
                pk.free_texture(tex)
        for name, ts in times.items():
            rows.append(_timing.times_row("gather", f"K{k}.{name}", ts,
                                          f"{r} lanes"))
    return rows
