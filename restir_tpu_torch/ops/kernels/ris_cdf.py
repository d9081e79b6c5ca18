"""Kernel B10: the general path's CDF RIS candidate stage with the
winner's shadow ray, and its plain PyTorch version.

Port of `restir_tpu.ops.pallas.ris_kernel.ris_cdf_pallas`
(`_ris_kernel`): per pixel, K draws from the exact per-pixel CDF over all
area lights, a single-draw winner, then an any hit of the winner's
shadow ray with self-exclusion of the pixel's own triangle and a relative
distance margin; an occluded winner's weight comes back zero. The math is
B1's RIS core, so the CUDA kernel (`csrc/ris_cdf.cu`) picks what
`di_core.cuh`'s `ris_select` picks and walks the scene's MTBVH
(`scene.bvh`) with the twin's leaf test, and the plain version calls
B1's twins (`fused_di.ris_pixels`, `fused_di.shadow_pixels`: every
triangle row) on a G-buffer-shaped view of the input pack. The light rows are
`tables.light_tables`'s (`ris_kernel.build_light_tables`' rows, no env
tiles).

Both take `pix0`, the global index of the pack's first pixel: a row band
(`restir_tpu_torch.parallel`) draws its pixel p's candidates as pixel
pix0 + p of the whole frame, and reads and writes the packs at p.

The kernel finds its K picks with B7's light search
(`csrc/ris_search.cuh`; `reuse`'s module note), a launch of its own
before the walk: the psi rows pass through a double buffer in shared
memory, several pixels a thread, with a cdf checkpoint every S rows
(`reuse.seg_for(n, False)`) and each candidate re-scans one segment from
device memory, so any light count fits a block (`smem_bytes`). It picks
what a full scan picks, bit for bit.

CUDA tensors launch the kernel, CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, fused_di, reuse
from .fused_di import (
    G_DIR,
    G_METAL,
    G_MTYPE,
    G_NORM,
    G_POS,
    G_PRIM,
    G_ROUGH,
    G_SHADE,
    GB_CH,
    MAX_K,
)
from .gbuffer import _check_bvh
from .tables import BvhTables, ResidentTables

launches = 0  # B10 launches (the walk; its search counts in reuse)

# input pack [CIN, R] and output pack [COUT, R] (ris_kernel.py:37-41)
IN_POS, IN_NORM, IN_WO = 0, 3, 6
IN_MTYPE, IN_METAL, IN_ROUGH, IN_SHADE, IN_PRIM = 9, 10, 11, 12, 13
CIN = 14
OUT_LI, OUT_WI, OUT_DIST, OUT_W, OUT_M = 0, 3, 6, 7, 8
COUT = 10  # li(3) wi(3) dist weight m pad


def pack_inputs(pos, norm, wo, mtype, metallic, roughness, shade, prim_id):
    """[CIN, R] float32 input pack in the TPU kernel's channel order."""
    return torch.cat([
        pos.T, norm.T, wo.T,
        torch.stack([mtype.to(torch.float32), metallic, roughness,
                     shade.to(torch.float32), prim_id.to(torch.float32)]),
    ]).contiguous()


def _gb_view(pack):
    """The gb-pack channels that B1's RIS and shadow twins read."""
    gb = torch.zeros((GB_CH, pack.shape[1]), dtype=torch.float32,
                     device=pack.device)
    gb[G_POS:G_POS + 3] = pack[IN_POS:IN_POS + 3]
    gb[G_NORM:G_NORM + 3] = pack[IN_NORM:IN_NORM + 3]
    gb[G_DIR:G_DIR + 3] = -pack[IN_WO:IN_WO + 3]
    gb[G_MTYPE] = pack[IN_MTYPE]
    gb[G_METAL] = pack[IN_METAL]
    gb[G_ROUGH] = pack[IN_ROUGH]
    gb[G_SHADE] = pack[IN_SHADE]
    gb[G_PRIM] = pack[IN_PRIM]
    return gb


def ris_cdf_ref(pack, looper, tables: ResidentTables, *, k=4,
                single_sided=True, has_met=True, pix0=0):
    """Plain B10: the [COUT, R] output pack; pixel p draws as global
    pixel pix0 + p."""
    r = pack.shape[1]
    out = torch.zeros((COUT, r), dtype=torch.float32, device=pack.device)
    gb = _gb_view(pack)
    pix = torch.arange(pix0, pix0 + r, device=pack.device)
    li, wi, dist, w = fused_di.ris_all(gb, pix, looper, tables, k=k,
                                       single_sided=single_sided,
                                       has_met=has_met)
    out[OUT_LI:OUT_LI + 3] = li
    out[OUT_WI:OUT_WI + 3] = wi
    out[OUT_DIST] = dist
    out[OUT_M] = torch.where(gb[G_SHADE] > 0.5, float(k), 0.0)
    chunk = fused_di.chunk_pixels(tables.planes.shape[0])
    for p0 in range(0, r, chunk):
        sl = slice(p0, p0 + chunk)
        out[OUT_W, sl] = fused_di.shadow_pixels(gb[:, sl], wi[:, sl],
                                                dist[sl], w[sl],
                                                tables.planes)
    return out


def smem_bytes(n_area: int) -> int:
    """B10's shared memory per block over n_area light rows: B7's
    env-less light search, its double buffer of psi rows and its
    checkpoints (`reuse.smem_bytes` at `reuse.seg_for(n_area, False)`)."""
    return reuse.smem_bytes(n_area, False, n_area,
                            reuse.seg_for(n_area, False))


def ris_cdf_cuda(pack, looper, tables: ResidentTables, bvh: BvhTables, *,
                 k=4, single_sided=True, has_met=True, pix0=0, stats=False,
                 lib=None, counts=None, _parts=3):
    """B10 on the card: the [COUT, R] output pack, pixel p drawn as
    global pixel pix0 + p. With `stats`, also the int32 [2, R] box and
    plane test counts of each shadow walk. `lib` and `counts` as
    `reuse.candidates_cuda`'s (the stage probes). B10 launches the
    light search, then its walk; `_parts=1` launches the search alone:
    the pack before visibility (the card's checks of the search)."""
    global launches
    r = pack.shape[1]
    dev = pack.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if pix0 < 0:
        raise ValueError(f"pix0 {pix0} < 0")
    if _parts not in (1, 3):
        raise ValueError(f"_parts={_parts}")
    if pack.dtype != torch.float32 or tuple(pack.shape) != (CIN, r):
        raise ValueError(f"input pack: expected float32 [{CIN}, {r}]")
    lights, psi = tables.lights, tables.psi
    for t in (lights, psi):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"light tables must be float32 on {dev}")
    _check_bvh(bvh, dev)
    l_pad = psi.shape[0]
    pack = pack.contiguous()
    out = torch.empty((COUT, r), dtype=torch.float32, device=dev)
    if counts is None and stats:
        counts = torch.empty((2, r), dtype=torch.int32, device=dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = (lib or _build.library()).restir_ris_cdf(
            p(pack), ctypes.c_uint32(looper & 0xFFFFFFFF),
            ctypes.c_uint32(pix0), p(lights), p(psi), l_pad, tables.n_lights,
            _parts, p(bvh.rows), bvh.size, p(bvh.planes), p(out), p(counts),
            r, int(single_sided), k, int(has_met), _build.stream_of(dev))
    _build.check(err, "restir_ris_cdf")
    reuse.search_launches += 1
    launches += _parts == 3
    return (out, counts) if counts is not None else out


def ris_cdf(pos, norm, wo, mtype, metallic, roughness, shade, prim_id,
            looper, tables: ResidentTables, bvh: BvhTables, *, k=4,
            single_sided=True, has_met=True, pix0=0):
    """(li [R, 3], wi [R, 3], dist [R], weight [R], m [R] int32) with the
    weights of occluded winners zeroed, as `ris_cdf_pallas` returns them.
    `norm` is the shading normal already turned toward wo. The kernel
    walks the scene's MTBVH `bvh`; the plain version reads none. Pixel p
    draws as global pixel pix0 + p."""
    pack = pack_inputs(pos, norm, wo, mtype, metallic, roughness, shade,
                       prim_id)
    kw = dict(k=k, single_sided=single_sided, has_met=has_met, pix0=pix0)
    if pack.device.type == "cpu":
        out = ris_cdf_ref(pack, looper, tables, **kw)
    elif pack.device.type == "cuda":
        out = ris_cdf_cuda(pack, looper, tables, bvh, **kw)
    else:
        raise ValueError(f"unsupported device {pack.device}")
    return (out[OUT_LI:OUT_LI + 3].T, out[OUT_WI:OUT_WI + 3].T,
            out[OUT_DIST], out[OUT_W], out[OUT_M].to(torch.int32))
