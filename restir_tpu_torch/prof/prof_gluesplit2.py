"""The host glue of the fused frame, piece by piece, on the hall and
the headline scene at 1920x1080 (EAW): host timers around pack_camera
(ops/camera.py), spatial.spatial_offsets, each kernel wrapper (its
Python, its allocations and its launch), the EAW chain, and the
allocations inside them (`torch.empty`, nested in the wrappers), beside
the wall of the same frames and the device busy of a profiled run. The
pieces and the rest of step_fused add up to the wall.

Port of the TPU probe prof/prof_gluesplit2.py, which split the hall's
XLA glue (sort, payload take, sub-block lists) around B7a
`_ris_select_kernel` (launched at :77). On the CPU the frames run
through the plain twins.

    python -m restir_tpu_torch.prof gluesplit2
"""

from __future__ import annotations

import torch

from ..config import DenoiserType
from ..models import restir_di_fused
from . import _scenes, _timing, _trace
from .prof_hallsplit import FRAMES, NESTED, frame_stepper, wrappers


def split(fr, device):
    cfg = fr.cfg.replace(denoiser=DenoiserType.EAW)
    step = frame_stepper(fr, device, cfg)
    frames = FRAMES if _timing.on_card(device) else 1
    for _ in range(2 if _timing.on_card(device) else 0):  # warm-up
        step()
    ms, _ = _trace.kernel_ms(step, frames, device)
    pieces = wrappers() + [
        (restir_di_fused, "eaw_filter_packed", "EAW chain"),
        (torch, "empty", "allocations")]
    timers, wall = _trace.host_split(step, frames, device, pieces)
    rows = []
    top = 0.0
    for piece, total in timers.ms.items():
        per = total / frames
        nested = piece in NESTED + ("allocations", "B3 wrapper")
        if not nested:
            top += per
        rows.append(_timing.row(
            "gluesplit2", f"{fr.name}.{piece}", per,
            f"{timers.calls[piece] / frames:g} calls a frame"
            + (", inside another piece" if nested else "")))
    rows.append(_timing.row("gluesplit2", f"{fr.name}.rest", wall - top,
                            "step_fused outside the pieces"))
    rows.append(_timing.row("gluesplit2", f"{fr.name}.wall", wall))
    if ms:
        busy = sum(ms.values())
        rows.append(_timing.row("gluesplit2", f"{fr.name}.busy", busy,
                                f"idle share {1 - busy / wall:.3f}"))
    return rows


def run(device="cuda", small=False):
    return (split(_scenes.hall(device, small), device)
            + split(_scenes.headline(device, small), device))
