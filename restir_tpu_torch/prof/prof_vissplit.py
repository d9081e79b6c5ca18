"""The shadow walks of B7 (`csrc/reuse_bvh.cu`, on the hall and the sky
hall) and B10 (`csrc/ris_cdf.cu`, on the general G-buffer of the hall and
the headline scene) split into their stages at 1920x1080, from builds
with `-DPROBE_WALK` (`csrc/prof/walk_probe.cuh`, `_build.VARIANTS`):
- full: the main library's kernel;
- search-only: the pixel's RIS (B7's light search) and no walk;
- fixed-node: the full walk's count of box and leaf tests for each ray,
  on rows that stay in L1 (no load waits on the last): the walk's
  arithmetic and issue without its dependent-load latency;
- no-leaf: the walk with box tests only, no triangle tested (and so no
  early exit).
full - search-only is the walk's cost; walk - fixed-node its latency.

Port of the TPU probe prof/prof_vissplit.py: B7a `_ris_select_kernel`
as the input (:233) and the vis kernel's modes full / noexit / mm /
arith / nocompute (:303), which split the DMA wait, the compute and the
loop. On the CPU only `full` runs, through the plain twins.

    python -m restir_tpu_torch.prof vissplit
"""

from __future__ import annotations

import warnings

import torch

from ..models import gbuffer as general_gb
from ..ops.kernels import _build, reuse, ris_cdf
from ..ops.kernels.fused_di import PT_CH
from . import _scenes, _timing

MODES = ("full", "search-only", "fixed-node", "no-leaf")
B7 = {"full": None, "search-only": "b7_search",
      "fixed-node": "b7_fixed_node", "no-leaf": "b7_no_leaf"}
B10 = {"full": None, "search-only": "b10_search",
       "fixed-node": "b10_fixed_node", "no-leaf": "b10_no_leaf"}
NOTES = {"full": "the kernel", "search-only": "no walk",
         "fixed-node": "the walk's tests without dependent loads",
         "no-leaf": "box tests only, no early exit",
         "no-exit": "walks to the table's end, the same pack"}


def b7_calls(fr, device, modes=B7):
    """{mode: a call of B7's candidates on frame 1 of fr}; on the CPU only
    the twin's `full` (B7 with B1b, `reuse.reuse`)."""
    gb = _scenes.gb_pack(fr)
    t, bvh, w = fr.scene.tables, fr.scene.bvh, fr.cfg.width
    kw = fr.rkw()
    if not _timing.on_card(device):
        prev = torch.zeros((PT_CH, gb.shape[1]), device=gb.device)
        return {"full": lambda: reuse.reuse(gb, prev, 1, t, bvh, width=w,
                                            **kw)}
    _, counts = reuse.candidates_cuda(gb, 1, t, bvh, width=w, stats=True,
                                      **kw)
    calls = {}
    for mode, var in modes.items():
        lib = _build.variant_library(var) if var else None
        cnt = counts.clone() if mode == "fixed-node" else None
        calls[mode] = (lambda lib=lib, cnt=cnt: reuse.candidates_cuda(
            gb, 1, t, bvh, width=w, lib=lib, counts=cnt, **kw))
    return calls


def b10_pack(fr):
    """B10's input pack from the general G-buffer of frame 1."""
    cfg = fr.cfg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "auto" takes the walk: its notice
        gbuf, it, mat, ray_dir = general_gb.render_gbuffer(
            fr.scene, fr.cam, fr.cam, cfg, 1)
    wo = -ray_dir
    shade = it.valid & (gbuf.prim_id != general_gb.LIGHT_ID)
    flip = (mat.type != 2) & ((it.norm * wo).sum(-1) < 0)
    norm = torch.where(flip[:, None], -it.norm, it.norm)
    return ris_cdf.pack_inputs(it.pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness, shade, it.prim_id)


def b10_calls(fr, device, modes=B10):
    pack = b10_pack(fr)
    t, bvh = fr.scene.tables, fr.scene.bvh
    c = fr.cfg
    kw = dict(k=c.cdf_candidates, single_sided=c.single_sided_lights,
              has_met=c.scene_has_metallic)
    if not _timing.on_card(device):
        return {"full": lambda: ris_cdf.ris_cdf_ref(pack, 1, t, **kw)}
    _, counts = ris_cdf.ris_cdf_cuda(pack, 1, t, bvh, stats=True, **kw)
    calls = {}
    for mode, var in modes.items():
        lib = _build.variant_library(var) if var else None
        cnt = counts.clone() if mode == "fixed-node" else None
        calls[mode] = (lambda lib=lib, cnt=cnt: ris_cdf.ris_cdf_cuda(
            pack, 1, t, bvh, lib=lib, counts=cnt, **kw))
    return calls


def _rows(kernel, fr, calls, device):
    rows = []
    times = _timing.interleaved(calls, device, rounds=2)
    for mode in MODES:
        name = f"{kernel}.{fr.name}.{mode}"
        if mode not in times:
            _timing.skipped("vissplit", name, "a stage build for the card")
            continue
        rows.append(_timing.times_row("vissplit", name, times[mode],
                                      NOTES[mode]))
    if "fixed-node" in times:
        full, search = (min(times[m].device) for m in ("full", "search-only"))
        fixed = min(times["fixed-node"].device)
        print(f"probe vissplit {kernel}.{fr.name}: walk {full - search:.4f} "
              f"ms, of which dependent-load latency {full - fixed:.4f} ms",
              flush=True)
    return rows


def run(device="cuda", small=False):
    rows = []
    for fr in (_scenes.hall(device, small),
               _scenes.hall(device, small, sky=True)):
        rows += _rows("B7", fr, b7_calls(fr, device), device)
    for fr in (_scenes.hall(device, small), _scenes.headline(device, small)):
        rows += _rows("B10", fr, b10_calls(fr, device), device)
    return rows
