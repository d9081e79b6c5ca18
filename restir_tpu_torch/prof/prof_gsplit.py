"""B6's cost split into its stages on the headline scene at 1920x1080:
the kernel whole, then builds of `csrc/gbuffer_bvh.cu` with each stage
stubbed (`-DPROBE_GBUF`, `_build.VARIANTS`).

Port of the TPU probe prof/prof_gsplit.py (full, no-epilogue and
no-hit-loop stubs of `_gbuffer_epilogue` / `_gbuffer_kernel_resident`,
:50-92; a const-only kernel, :101-120, launched at :113; a raygen-only
kernel, :123-158, launched at :147). Modes:
- full: the main library's B6;
- const: stores only (no ray, no walk, no epilogue);
- raygen: ray generation and the stores;
- hit: ray and walk, the hit stored without the epilogue;
- epi: ray and a constant hit into the real epilogue.
The stub builds write packs that are not the G-buffer; they have no
twin. On the CPU only `full` runs, through the plain twin.

    python -m restir_tpu_torch.prof gsplit
"""

from __future__ import annotations

from ..ops.kernels import _build, gbuffer
from . import _scenes, _timing

MODES = {"full": None, "const": "b6_const", "raygen": "b6_raygen",
         "hit": "b6_hit", "epi": "b6_epi"}
NOTES = {"full": "the kernel", "const": "stores only",
         "raygen": "ray generation and stores",
         "hit": "the walk, no epilogue",
         "epi": "a constant hit into the epilogue"}


def b6_calls(fr, device, modes=MODES):
    """{mode: a call of B6 (or its stage build) on frame 1 of fr}; on the
    CPU only the twin's `full`."""
    cv, cv2 = fr.cams()
    kw = fr.gkw()
    bvh = fr.scene.bvh
    calls = {}
    for mode, var in modes.items():
        if not _timing.on_card(device):
            if var is None:
                calls[mode] = lambda: gbuffer.gbuffer_pack(cv2, cv, 1, bvh,
                                                           **kw)
            continue
        lib = _build.variant_library(var) if var else None
        calls[mode] = (lambda lib=lib: gbuffer.gbuffer_cuda(
            cv2, cv, 1, bvh, lib=lib, **kw))
    return calls


def run(device="cuda", small=False):
    fr = _scenes.headline(device, small)
    calls = b6_calls(fr, device)
    rows = []
    times = _timing.interleaved(calls, device, rounds=1)
    for mode in MODES:
        if mode not in calls:
            _timing.skipped("gsplit", mode, "a stage build for the card")
            continue
        rows.append(_timing.times_row("gsplit", f"{fr.name}.{mode}",
                                      times[mode], NOTES[mode]))
    return rows
