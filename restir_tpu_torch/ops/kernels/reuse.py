"""Kernel B7: RIS + the winner's shadow ray through an MTBVH any-hit walk,
then B1's temporal merge; and the plain PyTorch twin of the whole.

Port of `restir_tpu.ops.pallas.fused_di.reuse_pallas` (its kernels
`_ris_select_kernel`, `_vis_sorted_kernel`, `_vis_resident_kernel` and
`_merge_sorted_kernel`): per pixel of a gb pack, K-candidate CDF RIS with a
single-draw winner, the winner's shadow ray, and the temporal merge with
the previous frame's reuse pack. Returns pt [PT_CH, R].

On CUDA tensors `reuse` launches `csrc/reuse_bvh.cu` (writes the candidate
pack rs [RS_CH, R]) and then B1's `di_temporal_kernel` through
`fused_di.temporal_cuda`; on CPU tensors it takes the twin `reuse_ref`
(B1's stages: `ris_pixels`, the brute `shadow_pixels`, `temporal_pixels`).
Nothing falls back. `has_env` adds the env tiles to the light CDF.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, fused_di
from .fused_di import GB_CH, MAX_K, PT_CH, RS_CH, SMEM_MAX, _check
from .gbuffer import _check_bvh
from .tables import BvhTables, ResidentTables

launches = 0  # reuse_bvh kernel launches


def reuse_ref(gb, prev_pt, looper, tables: ResidentTables, *, k=4,
              single_sided=True, temporal=True, temporal_clamp=20,
              has_met=True, has_env=False, pix=None):
    """Plain twin: pt columns for the gb columns of pixels `pix` (whole
    1024-pixel tiles in order; every pixel when None). prev_pt is the
    whole previous pack."""
    dev = gb.device
    if pix is None:
        pix = torch.arange(gb.shape[1], device=dev, dtype=torch.int64)
    out = torch.empty((PT_CH, pix.shape[0]), dtype=torch.float32,
                      device=dev)
    chunk = fused_di.chunk_pixels(tables.planes.shape[0])
    for p0 in range(0, pix.shape[0], chunk):
        g = gb[:, p0:p0 + chunk]
        px = pix[p0:p0 + chunk]
        li, wi, dist, w = fused_di.ris_pixels(
            g, px, looper, tables, k=k, single_sided=single_sided,
            has_met=has_met, has_env=has_env)
        w = fused_di.shadow_pixels(g, wi, dist, w, tables.planes)
        out[:, p0:p0 + chunk] = fused_di.temporal_pixels(
            g, li, wi, dist, w, px, looper, prev_pt, k=k, temporal=temporal,
            temporal_clamp=temporal_clamp)
    return out


def candidates_cuda(gb, looper, tables: ResidentTables, bvh: BvhTables, *,
                    k=4, single_sided=True, has_met=True, has_env=False,
                    stats=False):
    """Launch `csrc/reuse_bvh.cu` alone: rs [RS_CH, R] (li, wi, dist, W
    after visibility). With `stats`, also return the int32 [2, R] box and
    triangle test counts of each shadow ray."""
    global launches
    r = gb.shape[1]
    dev = gb.device
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    lights, psi = tables.light_rows(has_env)
    l_pad = psi.shape[0]
    if l_pad * 32 * 4 > SMEM_MAX:
        raise ValueError(f"B7 holds {l_pad} light rows in shared memory: "
                         f"{l_pad * 128} bytes, over the {SMEM_MAX} a block "
                         "can use")
    _check(gb, "gb", (GB_CH, r), dev)
    _check(lights, "lights", psi.shape, dev)
    _check(psi, "psi", psi.shape, dev)
    _check_bvh(bvh, dev)
    rs = torch.empty((RS_CH, r), dtype=torch.float32, device=dev)
    counts = (torch.empty((2, r), dtype=torch.int32, device=dev)
              if stats else None)
    p = _build.ptr
    err = _build.library().restir_reuse_bvh(
        p(gb), ctypes.c_uint32(looper & 0xFFFFFFFF), p(lights), p(psi),
        l_pad, tables.n_lights, int(has_env), p(bvh.rows), bvh.size,
        p(bvh.planes), p(rs), p(counts), r, int(single_sided), k,
        int(has_met), _build.stream_of(dev))
    _build.check(err, "restir_reuse_bvh")
    launches += 1
    return (rs, counts) if stats else rs


def reuse_cuda(gb, prev_pt, looper, tables: ResidentTables, bvh: BvhTables,
               *, k=4, single_sided=True, temporal=True, temporal_clamp=20,
               has_met=True, has_env=False):
    """Kernel B7, then B1b: pt [PT_CH, R]."""
    rs = candidates_cuda(gb, looper, tables, bvh, k=k,
                         single_sided=single_sided, has_met=has_met,
                         has_env=has_env)
    return fused_di.temporal_cuda(gb, rs, prev_pt, looper, k=k,
                                  temporal=temporal,
                                  temporal_clamp=temporal_clamp)


def reuse(gb, prev_pt, looper, tables: ResidentTables, bvh: BvhTables, *,
          k=4, single_sided=True, temporal=True, temporal_clamp=20,
          has_met=True, has_env=False):
    """pt [PT_CH, R] for one frame: the twin on CPU tensors, the kernels on
    CUDA tensors."""
    kw = dict(k=k, single_sided=single_sided, temporal=temporal,
              temporal_clamp=temporal_clamp, has_met=has_met,
              has_env=has_env)
    if gb.device.type == "cpu":
        return reuse_ref(gb, prev_pt, looper, tables, **kw)
    if gb.device.type == "cuda":
        return reuse_cuda(gb, prev_pt, looper, tables, bvh, **kw)
    raise ValueError(f"unsupported device {gb.device}")
