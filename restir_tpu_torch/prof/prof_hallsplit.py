"""The hall's fused frame (B6, B7, B1b, B2, 5 levels of B3 at 1920x1080,
EAW) split into its stages: each kernel's device ms per launch (a
torch.profiler trace), each wrapper's host ms per call and the host time
between them (host timers around the wrappers of an unprofiled run of
`renderer.step`), B7's search alone (the `b7_search` build) against B7
whole, and B7 with its early exit against a build that walks each
shadow ray to the end of the table (`b7_no_exit`, the same packs).

Port of the TPU probe prof/prof_hallsplit.py: R1 = B7a
`_ris_select_kernel` alone (:100), the XLA glue, and `_vis_sorted_kernel`
with early exit on and off (:184-208, launched at :186, `id/noexit`
against `near/exit`). On the CPU the frame runs through the plain twins
and only host times print.

    python -m restir_tpu_torch.prof hallsplit
"""

from __future__ import annotations

import torch

from .. import renderer
from ..config import DenoiserType
from ..models import restir_di_fused
from ..ops.kernels import atrous, fused_di, gbuffer, reuse, spatial
from . import _scenes, _timing, _trace
from .prof_vissplit import NOTES, b7_calls

FRAMES = 5
KERNELS = {"B6": "gbuffer_bvh_kernel", "B7 search": "ris_search_kernel",
           "B7 walk": "reuse_walk_kernel", "B1b": "di_temporal_kernel",
           "B2": "spatial_shade_kernel", "B3": "atrous_eaw_kernel"}
LAUNCHES = {"B6": 1, "B7 search": 1, "B7 walk": 1, "B1b": 1, "B2": 1,
            "B3": 5}
# pieces that run inside another wrapped piece ("B7 + B1b twin",
# `reuse.reuse`, calls both wrappers): left out of the sum of the pieces
NESTED = ("B7 wrapper", "B1b wrapper")


def wrappers():
    """(object, attribute, piece) of every call of the fused frame that
    the host timers wrap."""
    return [(restir_di_fused, "pack_camera", "pack_camera"),
            (spatial, "spatial_offsets", "spatial_offsets"),
            (fused_di, "di_resident", "B1 wrapper"),
            (gbuffer, "gbuffer_pack", "B6 wrapper"),
            (reuse, "candidates_cuda", "B7 wrapper"),
            (fused_di, "temporal_cuda", "B1b wrapper"),
            (reuse, "reuse", "B7 + B1b twin"),
            (spatial, "spatial_shade", "B2 wrapper"),
            (atrous, "atrous_level", "B3 wrapper")]


def frame_stepper(fr, device, cfg):
    state = renderer.init_state(cfg, fr.cam, fr.scene, device=device)

    def step():
        nonlocal state
        state, _ = renderer.step(fr.scene, state, fr.cam, cfg)
    return step


def run(device="cuda", small=False):
    fr = _scenes.hall(device, small)
    cfg = fr.cfg.replace(denoiser=DenoiserType.EAW)
    step = frame_stepper(fr, device, cfg)
    frames = FRAMES if _timing.on_card(device) else 1
    for _ in range(2 if _timing.on_card(device) else 0):  # warm-up
        step()
    rows = []
    ms, _ = _trace.kernel_ms(step, frames, device)
    if ms:
        per = _trace.by_kernel(ms, KERNELS)
        for k, n in LAUNCHES.items():
            rows.append(_timing.row("hallsplit", f"{k}.device", per[k] / n,
                                    f"per launch, {n} a frame"))
        rows.append(_timing.row("hallsplit", "other.device", per["other"],
                                "PyTorch's kernels a frame"))
        rows.append(_timing.row("hallsplit", "frame.busy", sum(ms.values())))
    timers, wall = _trace.host_split(step, frames, device, wrappers())
    for piece, total in timers.ms.items():
        n = timers.calls[piece] / frames
        rows.append(_timing.row(
            "hallsplit", f"{piece}.host", total / frames,
            f"{n:g} calls a frame"
            + (", inside another piece" if piece in NESTED else "")))
    rest = wall - sum(ms_ for piece, ms_ in timers.ms.items()
                      if piece not in NESTED) / frames
    rows.append(_timing.row("hallsplit", "between.host", rest,
                            "the frame's host time outside the wrappers"))
    rows.append(_timing.row("hallsplit", "frame.wall", wall))
    if not _timing.on_card(device):
        _timing.skipped("hallsplit", "B7 stage builds", "for the card")
        return rows
    calls = b7_calls(fr, device, {"full": None, "search-only": "b7_search",
                                  "no-exit": "b7_no_exit"})
    same = torch.equal(calls["full"](), calls["no-exit"]())
    print(f"probe hallsplit: B7 without its early exit writes the same "
          f"pack: {same}", flush=True)
    if not same:
        raise RuntimeError("hallsplit: the b7_no_exit build's pack differs")
    times = _timing.interleaved(calls, device, rounds=2)
    for mode, ts in times.items():
        rows.append(_timing.times_row("hallsplit", f"B7.{mode}", ts,
                                      NOTES[mode]))
    return rows
