"""Ray order for the walks at 1920x1080 on the hall's NEE segments: the
coherence key (`csrc/sort.cu`) in the three orders of `walk_ab.py
order`, cut to 30 bits, against its torch twin; the hand-written
one-sweep radix sort (a histogram launch, then one launch a pass of
`kernels.SORT_BITS`-bit digits, stable) against torch.sort(stable=True)
and torch.argsort; then B13's any hit on the segments in pixel order
(8x4-pixel warps, as the render paths launch it) and in ray order,
against sorted order with the key, the sort, the gather of B13's inputs
and the scatter of its flags back included. Every row is the device time
of one call (its kernels summed); the CUDA-event time is beside it.

Port of the TPU probe prof/prof_wavefront.py: B7a `_ris_select_kernel`
as the input (:87), coherence keys, `jnp.argsort`, the payload gather and
the take by the inverse permutation (:213). The key and the sort's
permutation equal their twins bit for bit; sorted B13 writes the pixel
order's flags.

    python -m restir_tpu_torch.prof wavefront
"""

from __future__ import annotations

import torch

from ..ops.kernels import intersect as hits
from . import _scenes, _timing
from . import kernels as pk
from .prof_take import inputs


def sorted_pieces(trv, pos, target, live, lo, hi, order):
    """B13's any hit on the segments in the key's order, back in pixel
    order, as named steps: key, sort, gather of B13's inputs (x, y, live)
    straight from (pos, target, live), the walk on the sorted rows,
    scatter of the flags back. Returns ({step: a call of it alone}, a
    call of the whole)."""
    key = pk.coherence_key(pos, target, live, lo, hi, order)
    _, perm = pk.radix_sort(key)
    x, y, sl = pk.gather_rays(perm, pos, target, live)
    occ_s = hits.any_hit(trv, x, y, sl)

    def whole():
        k = pk.coherence_key(pos, target, live, lo, hi, order)
        _, pm = pk.radix_sort(k)
        return pk.scatter_cols(hits.any_hit(trv, *pk.gather_rays(
            pm, pos, target, live)), pm)

    steps = {"key": lambda: pk.coherence_key(pos, target, live, lo, hi,
                                             order),
             "sort": lambda: pk.radix_sort(key),
             "gather": lambda: pk.gather_rays(perm, pos, target, live),
             "walk": lambda: hits.any_hit(trv, x, y, sl),
             "scatter": lambda: pk.scatter_cols(occ_s, perm)}
    return steps, whole


def run(device="cuda", small=False):
    fr, trv, pos, target, live, _, _ = inputs(device, small)
    lo, hi = _scenes.scene_box(fr)
    rows = []
    for order in pk.KEY_ORDERS:
        key = pk.coherence_key(pos, target, live, lo, hi, order)
        ref = pk.coherence_key_ref(pos, target, live, lo, hi, order)
        if not torch.equal(key, ref):
            raise RuntimeError(f"wavefront: the {order} key differs from "
                               "its twin")
        vals, perm = pk.radix_sort(key)
        rv, rp = pk.radix_sort_ref(key)
        if not (torch.equal(vals, rv) and torch.equal(perm, rp)):
            raise RuntimeError(f"wavefront: the radix sort of the {order} "
                               "keys differs from torch.sort(stable=True)")
        times = _timing.interleaved({
            "key": lambda: pk.coherence_key(pos, target, live, lo, hi, order),
            "radix_sort": lambda: pk.radix_sort(key),
            "torch.sort": lambda: torch.sort(key, stable=True),
            "torch.argsort": lambda: torch.argsort(key)}, device, rounds=2)
        for name, ts in times.items():
            rows.append(_timing.times_row("wavefront", f"{order}.{name}",
                                          ts))
    w = fr.cfg.width
    base = hits.any_hit(trv, pos, target, live, geom=(w, 0))
    # on the CPU the lockstep twin takes seconds a call: one order, no times
    orders = pk.KEY_ORDERS if _timing.on_card(device) else pk.KEY_ORDERS[-1:]
    pieces = {}
    for order in orders:
        pieces[order] = sorted_pieces(trv, pos, target, live, lo, hi, order)
        if not torch.equal(pieces[order][1](), base):
            raise RuntimeError(f"wavefront: B13 in {order} order differs")
    print(f"probe wavefront: B13 in {', '.join(orders)} order writes the "
          "pixel order's bits", flush=True)
    if not _timing.on_card(device):
        _timing.skipped("wavefront", "B13 times", "the card's walk")
        return rows
    calls = {"B13.pixel_order": lambda: hits.any_hit(trv, pos, target, live,
                                                     geom=(w, 0)),
             "B13.ray_order": lambda: hits.any_hit(trv, pos, target, live)}
    for order in pk.KEY_ORDERS:
        steps, whole = pieces[order]
        calls[f"B13.sorted_{order}"] = whole
        for step, fn in steps.items():
            calls[f"B13.sorted_{order}.{step}"] = fn
    times = _timing.interleaved(calls, device, rounds=2)
    for name, ts in times.items():
        note = ("key, sort, gather, walk and scatter"
                if name.startswith("B13.sorted") and name.count(".") == 1
                else "the walk" if "order" in name.split(".")[-1] else "")
        rows.append(_timing.times_row("wavefront", f"{fr.name}.{name}", ts,
                                      note))
    return rows
