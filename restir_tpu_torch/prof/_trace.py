"""Frame tracing of the probes: host timers wrapped around named
functions of the port for the length of a `with` block, and the device
ms per kernel name from a torch.profiler trace."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from . import _timing


@contextmanager
def host_timed(pieces, timers: _timing.HostTimers):
    """Wrap each (object, attribute, piece) in `pieces` with a host timer
    of `timers` for the block; the originals come back after it. The
    callers look the attributes up at call time, so the frame runs its
    own code, each piece timed."""
    saved = []
    try:
        for obj, attr, piece in pieces:
            fn = getattr(obj, attr)
            saved.append((obj, attr, fn))
            setattr(obj, attr, timers.wrap(piece, fn))
        yield timers
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def host_split(step, frames, device, pieces):
    """(HostTimers over `pieces`, wall ms a frame) of `frames` calls of
    step() with the host timers on, from a drained queue to a drained
    queue."""
    timers = _timing.HostTimers()
    _timing.sync(device)
    with host_timed(pieces, timers):
        t0 = time.perf_counter()
        for _ in range(frames):
            step()
        _timing.sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / frames
    return timers, wall


def kernel_ms(step, frames, device, tries=3):
    """({kernel name: device ms per frame}, wall ms per frame) over
    `frames` calls of step() after one profiled but discarded call (a
    trace may miss the kernels of its first step); on the CPU, where no
    device runs, ({}, None) without a call."""
    if not _timing.on_card(device):
        return {}, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step()
            torch.cuda.synchronize(device)
            prof.step()
            t0 = time.perf_counter()
            for _ in range(frames):
                step()
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3 / frames
            prof.step()
        ms = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("ProfilerStep")):
                ms[e.name] = ms.get(e.name, 0.0) + (
                    e.time_range.elapsed_us() / 1e3 / frames)
        if ms:
            return ms, wall
    return {}, wall


def by_kernel(ms: dict, names: dict) -> dict:
    """{label: summed ms} of the kernels whose name holds each label's
    substring, the rest under "other"."""
    out = {label: 0.0 for label in names}
    out["other"] = 0.0
    for k, v in ms.items():
        for label, sub in names.items():
            if sub in k:
                out[label] += v
                break
        else:
            out["other"] += v
    return out
