"""B6's five stage builds on the hall and the headline scene at
1920x1080, built up front and timed in turns (interleaved A/B repeats),
and the `full` variant build held to the main library's pack bit for
bit.

Port of the TPU probe prof/prof_gvariants.py: `make_kernel(mode)` for
the modes const, raygen, hit, epi and full (:169), one pallas_call each
(:142), timed round by round (`main`). Here the modes are builds of
`csrc/gbuffer_bvh.cu` (`-DPROBE_GBUF`; prof_gsplit says what each stubs).
On the CPU only `full` runs, through the plain twin.

    python -m restir_tpu_torch.prof gvariants
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build, gbuffer
from . import _scenes, _timing
from .prof_gsplit import MODES, b6_calls

ROUNDS = 3


def full_build_equal(fr) -> bool:
    """The `b6_full` build (the source without a PROBE macro, built as a
    variant) writes the main library's pack bit for bit."""
    cv, cv2 = fr.cams()
    kw = fr.gkw()
    main = gbuffer.gbuffer_cuda(cv2, cv, 1, fr.scene.bvh, **kw)
    var = gbuffer.gbuffer_cuda(cv2, cv, 1, fr.scene.bvh,
                               lib=_build.variant_library("b6_full"), **kw)
    return torch.equal(main, var)


def run(device="cuda", small=False):
    rows = []
    for fr in (_scenes.hall(device, small), _scenes.headline(device, small)):
        calls = b6_calls(fr, device)
        if _timing.on_card(device):
            same = full_build_equal(fr)
            print(f"probe gvariants {fr.name}: the b6_full build's pack "
                  f"equals the main library's: {same}", flush=True)
            if not same:
                raise RuntimeError(f"gvariants: b6_full differs on {fr.name}")
        times = _timing.interleaved(calls, device, rounds=ROUNDS)
        for mode in MODES:
            if mode not in times:
                _timing.skipped("gvariants", f"{fr.name}.{mode}",
                                "a stage build for the card")
                continue
            ts = sorted(times[mode].device)
            rows.append(_timing.times_row(
                "gvariants", f"{fr.name}.{mode}", times[mode],
                f"min of {ROUNDS} rounds; median {ts[len(ts) // 2]:.4f}"))
    return rows
