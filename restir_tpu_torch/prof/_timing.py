"""Timing helpers of the probes: interleaved A/B repeats (as the TPU's
prof_gvariants.main) that take each call's device time from a
torch.profiler trace (the summed durations of what it puts on the card)
and, beside it, CUDA events around back-to-back calls; host timers around
pieces of host code, the card's name and power limit, and the probes'
row format.

CUDA events around back-to-back calls measure the host's issue time
where a call's kernels are shorter than its wrapper (a few µs of ctypes
and checks a launch): the device time is each row's number, the event
time printed beside it shows the host's share.

On a CPU device (the tests) the same helpers take host time instead:
those numbers are CPU times, never a card's.
"""

from __future__ import annotations

import subprocess
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

WARMUP = 1  # launches before a timed run
REPS = 5  # launches per timed run
LEAD = 4  # fills that open a traced step (`device_ms`)


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean ms per call of fn over `reps` calls after `warmup` calls: CUDA
    events on a CUDA device, the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        reps, warmup = 1, 0  # the CPU's twins: one call shows the path
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


class Times(NamedTuple):
    """ms a call of one function, per round (host ms on the CPU)."""
    device: list  # the summed device time of the call's kernels and copies
    events: list  # CUDA events around back-to-back calls


# traces `device_ms` took again because they lost marks (read by the
# callers that report how often a trace had to be retaken)
retakes = 0


def _spans(fns: dict, device, reps: int):
    """(device ms a call of each fn, or None where the trace lost marks;
    the marks and the device events the trace held): one trace, as
    `device_ms` describes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from .kernels import mark

    names = list(fns)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for n in (1, reps):
            lead = torch.empty(1, device=device)
            for _ in range(LEAD):
                lead.fill_(0.0)
            torch.cuda.synchronize(device)
            for name in names:
                mark(device)
                for _ in range(n):
                    fns[name]()
            mark(device)
            torch.cuda.synchronize(device)
            prof.step()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events)
             if "probe_mark_kernel" in e.name]
    if len(marks) <= len(names):
        return None, (len(marks), len(events))
    ends = marks[-len(names) - 1:]
    return ({name: sum(e.time_range.elapsed_us()
                       for e in events[i + 1:j]) / 1e3 / reps
             for name, i, j in zip(names, ends, ends[1:])},
            (len(marks), len(events)))


def device_ms(fns: dict, device, reps: int = REPS, tries: int = 5) -> dict:
    """{name: device ms a call}: the summed durations of everything `reps`
    calls of each fn put on the card (kernels, copies, fills), from one
    torch.profiler trace of every fn in turn, each fn's calls between two
    launches of the marker kernel (`kernels.mark`; one stream, so the
    trace's order is the card's). The trace's first step, one call of
    each fn, is discarded, and each step starts with LEAD kernels that
    are no marks (a trace may miss the first kernels after it starts);
    the spans are those between the step's last len(fns) + 1 marks (a
    trace may also hold the discarded step's). A trace with fewer marks
    is taken again, up to `tries` times; then each fn gets traces of its
    own, up to `tries` each, before the call raises. Each retaken
    trace is printed with the (marks, device events) it held."""
    found = []

    def traced(part):
        global retakes
        ms, held = _spans(part, device, reps)
        if ms is None:
            retakes += 1
            found.append(held)
            print(f"device_ms: a trace of {list(part)} held (marks, events) "
                  f"{held}; {len(part) + 1} marks needed", flush=True)
        return ms

    for _ in range(tries):
        ms = traced(fns)
        if ms is not None:
            return ms
    out = {}
    for name, fn in fns.items():
        for _ in range(tries):
            ms = traced({name: fn})
            if ms is not None:
                out.update(ms)
                break
        else:
            raise RuntimeError(
                f"device_ms: traces missed marks of {list(fns)}, and "
                f"{tries} of {name!r} alone (marks, events: {found})")
    return out


def interleaved(fns: dict, device, rounds: int = 3, reps: int = REPS,
                warmup: int = WARMUP) -> dict:
    """{name: Times}: every fn warmed up first, then timed in turns, round
    by round, so drift of the card's clock falls on all: each round times
    every fn by CUDA events, then takes one trace of them all
    (`device_ms`)."""
    if torch.device(device).type != "cuda":
        rounds, warmup = 1, 0
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    out = {name: Times([], []) for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].events.append(time_ms(fn, device, reps=reps, warmup=0))
        if on_card(device):
            for name, ms in device_ms(fns, device, reps=reps).items():
                out[name].device.append(ms)
        else:
            for name in fns:
                out[name].device.append(out[name].events[-1])
    return out


class HostTimers:
    """Host ms summed per piece: `with timers("piece"): ...`, or
    `timers.wrap("piece", fn)` for a function timed at every call."""

    def __init__(self):
        self.ms = {}
        self.calls = {}

    @contextmanager
    def __call__(self, piece):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(piece, (time.perf_counter() - t0) * 1e3)

    def add(self, piece, ms):
        self.ms[piece] = self.ms.get(piece, 0.0) + ms
        self.calls[piece] = self.calls.get(piece, 0) + 1

    def wrap(self, piece, fn):
        def timed(*a, **kw):
            with self(piece):
                return fn(*a, **kw)
        return timed


def card_line(device="cuda") -> str:
    """nvidia-smi's name and power limit of the card, or the CPU's note."""
    if torch.device(device).type != "cuda":
        return "device: cpu (plain twins; host ms of the CPU, not a card's)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def row(probe: str, variant: str, ms: float, note: str = "") -> tuple:
    """Print and return one row: `probe <name> <variant>: <ms>`."""
    print(f"probe {probe} {variant}: {ms:.4f}" + (f"  ({note})" if note
                                                     else ""), flush=True)
    return (probe, variant, ms)


def times_row(probe: str, variant: str, t: Times, note: str = "") -> tuple:
    """Print and return one row of a function's least device ms over its
    rounds, with its least CUDA-event ms beside it."""
    ms = min(t.device)
    return row(probe, variant, ms, f"events {min(t.events):.4f}"
               + (f"; {note}" if note else ""))


def skipped(probe: str, variant: str, why: str) -> None:
    print(f"probe {probe} {variant}: not run ({why})", flush=True)
