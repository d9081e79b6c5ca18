"""How much coherence a ray sort can recover for B7's shadow walks: on
the hall's 32 sample regions (32x32 pixels each, placed at chip_smoke.py
phase 9's 32 tiles) at 1920x1080, per 8x4-pixel warp (B7's launch) and
per 32x1 strip, the size of the union of the node rows the warp's lanes
visit (the rows it must load) against the sum of the rows each lane
visits (what a lane walks alone), in pixel order and with the sample's
rays sorted by their coherence key (groups of 32 consecutive rays).
On the card the segments are B7's own winners (the candidate pack of
`reuse.candidates_cuda`) and the sorted order comes from the coherence
key and radix sort of `csrc/sort.cu`; on the CPU from their twins
(`fused_di.ris_pixels`, `coherence_key_ref`, torch.sort). The rows a
lane visits are counted by the lockstep twin of B7's walk
(`ops/kernels/bvh_walk.py`, the padded walk with B7's leaf test).

Port of the TPU probe prof/prof_union.py: B7a `_ris_select_kernel` as
the input (:62) and the unions of sub-block work lists per ray group.
Prints counts (rows), not times, after the `ms` of the count.

    python -m restir_tpu_torch.prof union
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.kernels import bvh_walk, fused_di, reuse
from ..ops.kernels.fused_di import G_POS, G_PRIM, G_SHADE, RS_DIST, RS_WI
from . import _scenes, _timing
from . import kernels as pk

REGIONS = 32
SIDE = 32  # a region is SIDE x SIDE pixels
TILE = 1024  # chip_smoke.py's sample tiles


def region_pixels(width, height, device, regions=REGIONS, side=SIDE):
    """Global pixel ids [regions, side, side] of square regions at the
    first pixel of phase 9's sample tiles (clamped into the frame)."""
    r = width * height
    tiles = np.linspace(0, r // TILE - 1, regions).round().astype(int)
    side = min(side, width, height)
    x0 = np.minimum((tiles * TILE) % width, width - side)
    y0 = np.minimum((tiles * TILE) // width, height - side)
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pix = (y0[:, None, None] + yy) * width + x0[:, None, None] + xx
    return torch.as_tensor(pix, dtype=torch.int64, device=device)


def shadow_rays(fr, pix):
    """B7's shadow rays at global pixels pix: (o, d, limit, self prim),
    limit -1 where the pixel has no live winner. The winners are B7's
    (its candidate pack, before visibility zeroes W) on the card, its
    twin's on the CPU; both write dist 0 where no candidate won."""
    gb = _scenes.gb_pack(fr)
    kw = fr.rkw()
    if _timing.on_card(gb.device):
        rs = reuse.candidates_cuda(gb, 1, fr.scene.tables, fr.scene.bvh,
                                   width=fr.cfg.width, **kw)[:, pix]
        wi, dist = rs[RS_WI:RS_WI + 3], rs[RS_DIST]
        gb = gb[:, pix]
    else:
        gb = gb[:, pix]
        _, wi, dist, _ = fused_di.ris_pixels(
            gb, pix, 1, fr.scene.tables, k=kw["k"],
            single_sided=kw["single_sided"], has_met=kw["has_met"],
            has_env=kw["has_env"])
    live = (gb[G_SHADE] > 0.5) & (dist > 0.0)
    o = tuple(gb[G_POS + c] + wi[c] * 1e-5 for c in range(3))
    limit = torch.where(live, dist * (1.0 - 1e-3) - 1e-4, -1.0)
    return o, tuple(wi), limit, gb[G_PRIM].to(torch.int32)


def visited(bvh, o, d, limit, self_prim):
    """(lane, node row) of every box test of the lockstep any-hit walk
    (bvh_walk.occluded_walk's steps, early exit included)."""
    n = d[0].shape[0]
    dev = d[0].device
    base, inv = bvh_walk._start(bvh, d)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    cull = limit * bvh_walk.CULL_SLACK
    self_prim = self_prim.to(torch.int64)
    live = torch.nonzero(limit > 0.0)[:, 0]
    lanes, rows = [], []
    while live.numel():
        oa = tuple(c[live] for c in o)
        row = base[live] + node[live]
        lanes.append(live)
        rows.append(row)
        nd, hit, t_near = bvh_walk._step(bvh, base[live], node[live], oa,
                                         tuple(c[live] for c in inv))
        descend = hit & (t_near <= cull[live])
        leaf = descend & (nd[:, 0] >= 0) & (nd[:, 0] != self_prim[live])
        hit_lanes = live[leaf]
        t, _, _ = bvh_walk.di_plane(bvh.planes, nd[leaf, 0],
                                    tuple(c[leaf] for c in oa),
                                    tuple(c[hit_lanes] for c in d))
        occ[hit_lanes[(t >= 0.0) & (t < limit[hit_lanes])]] = True
        node[live] = torch.where(descend, node[live] + 1, nd[:, 1])
        live = live[(node[live] < bvh.size) & ~occ[live]]
    if not lanes:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    return torch.cat(lanes), torch.cat(rows)


def union_stats(group, lanes, rows, n_rows, n_groups):
    """(mean union of rows per group, mean of the lanes' summed rows per
    group), over groups of lanes (`group`: lane -> group id)."""
    g = group[lanes]
    per_lane = torch.bincount(g, minlength=n_groups).double()
    uniq = torch.unique(g * n_rows + rows)
    union = torch.bincount(uniq // n_rows, minlength=n_groups).double()
    return float(union.mean()), float(per_lane.mean())


def run(device="cuda", small=False):
    fr = _scenes.hall(device, small)
    w, h = fr.cfg.width, fr.cfg.height
    pix = region_pixels(w, h, fr.device, regions=4 if small else REGIONS)
    regions, side = pix.shape[0], pix.shape[1]
    flat = pix.reshape(-1)
    t0 = time.perf_counter()
    o, d, limit, self_prim = shadow_rays(fr, flat)
    lanes, rows = visited(fr.scene.bvh, o, d, limit, self_prim)
    ms = (time.perf_counter() - t0) * 1e3
    n_rows = 6 * fr.scene.bvh.size
    lane = torch.arange(flat.numel(), device=fr.device)
    loc = lane % (side * side)
    reg = lane // (side * side)
    x, y = loc % side, loc // side
    per_side = side // 8
    groups = {
        "8x4": reg * (side * side // 32) + (y // 4) * per_side + x // 8,
        "32x1": reg * side + y,
    }
    # sorted: the sample's rays by their coherence key, 32 at a time
    pos = torch.stack(o, 1).contiguous()
    tgt = (pos + torch.stack(d, 1) * torch.clamp(limit, min=0.0)[:, None])
    lo, hi = _scenes.scene_box(fr)
    key = pk.coherence_key(pos, tgt.contiguous(), limit > 0.0, lo, hi,
                           "direction_origin")
    rank = torch.empty_like(lane)
    rank[pk.radix_sort(key)[1].long()] = lane
    groups["sorted 32"] = rank // 32
    out = []
    for name, grp in groups.items():
        n_groups = int(grp.max()) + 1
        u, s = union_stats(grp, lanes, rows, n_rows, n_groups)
        out.append(_timing.row(
            "union", f"{fr.name}.{name}", ms,
            f"rows per group: union {u:.1f}, summed over lanes {s:.1f}, "
            f"ratio {u / max(s, 1e-9):.3f}; {regions} regions of "
            f"{side}x{side}"))
    return out
