"""Timing helpers of the probes: device ms by CUDA events with warm-up,
interleaved A/B repeats (as the TPU's prof_gvariants.main), host timers
around pieces of host code, the card's name and power limit, and the
probes' row format.

On a CPU device (the tests) the same helpers take host time instead:
those numbers are CPU times, never a card's.
"""

from __future__ import annotations

import subprocess
import time
from contextlib import contextmanager

import torch

WARMUP = 1  # launches before a timed run
REPS = 5  # launches per timed run


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


def interleaved(fns: dict, device, rounds: int = 3, reps: int = REPS,
                warmup: int = WARMUP) -> dict:
    """{name: [ms of each round]}: every fn warmed up first, then timed in
    turns, round by round, so drift of the card's clock falls on all."""
    if torch.device(device).type != "cuda":
        rounds, warmup = 1, 0
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(time_ms(fn, device, reps=reps, warmup=0))
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


def skipped(probe: str, variant: str, why: str) -> None:
    print(f"probe {probe} {variant}: not run ({why})", flush=True)
