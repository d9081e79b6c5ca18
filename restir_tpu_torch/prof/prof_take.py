"""The permuted gather of a 9-channel pack of shadow segments at
1920x1080 (the hall's NEE segments, sorted by their coherence key): the
hand-written gather (`csrc/sort.cu`) against index_select and
advanced indexing, its inverse (the kernel's scatter mode) against
index_copy_, beside a plain copy of the pack (the gather's floor: what
moving the bytes in order costs) and copy_. Device time a call, the
CUDA events beside it.

Port of the TPU probe prof/prof_take.py: `jnp.take` of the 9-channel rp
pack by the wavefront permutation in several formulations, and `_pin`
(:140), an identity copy through VMEM. The gather equals index_select
bit for bit.

    python -m restir_tpu_torch.prof take
"""

from __future__ import annotations

import torch

from ..ops import intersect
from . import _scenes, _timing
from . import kernels as pk

C = 9  # o (3), d (3), limit, live, pad: prof_take's rp pack


def segment_pack(pos, target, live):
    """[9, R]: origin, unit direction, length less 2e-4 (-1 where not
    live), live, 0."""
    seg = target - pos
    dist = seg.norm(dim=1)
    d = seg / torch.clamp(dist, min=1e-20)[:, None]
    limit = torch.where(live, dist - 2e-4, -1.0)
    return torch.cat([pos.T, d.T, limit[None], live[None].float(),
                      torch.zeros_like(limit)[None]]).contiguous()


def inputs(device, small):
    fr = _scenes.hall(device, small)
    trv = intersect.traversal_arrays(fr.scene, "bvh")
    pos, target, live = _scenes.nee_segments(fr, trv)
    lo, hi = _scenes.scene_box(fr)
    key = pk.coherence_key(pos, target, live, lo, hi, "direction_origin")
    _, perm = pk.radix_sort(key)
    return fr, trv, pos, target, live, key, perm


def run(device="cuda", small=False):
    fr, _, pos, target, live, _, perm = inputs(device, small)
    pack = segment_pack(pos, target, live)
    perm_l = perm.long()
    got = pk.gather_cols(pack, perm)
    same = torch.equal(got, pack.index_select(1, perm_l))
    print(f"probe take: the gather equals index_select: {same} "
          f"([{C}, {pack.shape[1]}])", flush=True)
    if not same:
        raise RuntimeError("take: the gather differs from index_select")
    if not torch.equal(pk.scatter_cols(got, perm), pack):
        raise RuntimeError("take: the scatter does not invert the gather")
    calls = {"copy": lambda: pk.copy_pack(pack),
             "copy_": lambda: torch.empty_like(pack).copy_(pack),
             "gather": lambda: pk.gather_cols(pack, perm),
             "index_select": lambda: pack.index_select(1, perm_l),
             "adv_index": lambda: pack[:, perm_l],
             "scatter": lambda: pk.scatter_cols(got, perm),
             "index_copy_": lambda: torch.empty_like(got).index_copy_(
                 1, perm_l, got)}
    times = _timing.interleaved(calls, device, rounds=2)
    return [_timing.times_row("take", f"{fr.name}.{k}", v)
            for k, v in times.items()]
