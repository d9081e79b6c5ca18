"""Table gathers at R = 1920 x 1088 with index (i * 7919) % K from a
float32 table of K = 1024 and 8192 entries, three ways
(`csrc/prof/mem.cu`): from shared memory, through the read-only cache
(__ldg) and from a texture object, against index_select (bit for bit).

Port of the TPU probe prof/prof_gather.py: `take_along_axis` on tables
in VMEM (the pallas_call at :43), the texture fetch candidates.

Each timed call finds its index and output cold in the card's 50 MB L2
(`cold`), as the bound (bytes at HBM's rate) assumes; the table itself
(4 or 32 KB) is read by every call and stays warm.

    python -m restir_tpu_torch.prof gather
"""

from __future__ import annotations

import itertools

import torch

from . import _timing
from . import kernels as pk

R = 1920 * 1088
SIZES = (1024, 8192)
COLD_SETS = 8  # index copies a timed gather turns through


def cold(fn, idx, sets=COLD_SETS):
    """A call of fn(index) on the next of `sets` copies of idx, whose
    output is kept until that copy comes round again (its storage then
    takes the new output): between two uses of a copy the other calls
    move (sets - 1) x 16.7 MB at K = 8192 (R = 1920 x 1088, an int32
    index read and a float32 output written), over twice the L2."""
    copies = [idx.clone() for _ in range(sets)]
    kept = [None] * sets
    turn = itertools.count()

    def call():
        i = next(turn) % sets
        kept[i] = None
        kept[i] = fn(copies[i])
        return kept[i]

    return call


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
            calls = {w: cold(lambda ix, w=w: pk.table_gather(table, ix, w,
                                                             tex=tex), idx)
                     for w in pk.GATHER_WHERE}
            calls["index_select"] = cold(
                lambda ix: table.index_select(0, ix), idx.long())
            times = _timing.interleaved(calls, device, rounds=2)
        finally:
            if tex is not None:
                _timing.sync(device)
                pk.free_texture(tex)
        for name, ts in times.items():
            rows.append(_timing.times_row("gather", f"K{k}.{name}", ts,
                                          f"{r} lanes"))
    return rows
