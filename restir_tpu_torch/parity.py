"""Parity gates between two renderings of the same frame.

One definition of "agrees" for the G-buffer and reuse packs, used by
the CPU tests (port vs the JAX package) and by `chip_smoke.py` (CUDA
kernel vs its plain twin on the card). The gates are the JAX package's
own (tests/test_fused_di.py): f32 arithmetic in another order may flip
a rare argmin tie or RIS pick, so lanes are compared where the
primitive / pick agree and the flips are bounded.
"""

from __future__ import annotations

import numpy as np

from .ops.kernels.fused_di import (
    G_DEPTH,
    G_DIR,
    G_LIGHT,
    G_MISS,
    G_MOTION,
    G_NORM,
    G_POS,
    G_PRIM,
    G_SHADE,
    P_LI,
    P_M,
    P_WEIGHT,
)

PRIM_MATCH_MIN = 0.998
MOTION_MATCH_MIN = 0.99
PICK_MATCH_MIN = 0.995
WEIGHT_CLOSE_MIN = 0.999
M_MATCH_MIN = 0.9999


def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float32)
    return a.reshape(a.shape[0], -1)


def gb_report(gb_ref, gb):
    """Compare a gb pack against gb_ref. Returns (failures, stats):
    failures is a list of strings (empty = all gates pass)."""
    gb_ref, gb = _np(gb_ref), _np(gb)
    fails = []
    stats = {}

    same = gb_ref[G_PRIM] == gb[G_PRIM]
    stats["prim_match"] = float(same.mean())
    if same.mean() < PRIM_MATCH_MIN:
        fails.append(f"primitive match {same.mean():.5f} < {PRIM_MATCH_MIN}")
    hit = same & (gb_ref[G_PRIM] >= 0)

    def close(ch, n, rtol, atol, mask):
        a = gb_ref[ch:ch + n][:, mask]
        b = gb[ch:ch + n][:, mask]
        return np.allclose(a, b, rtol=rtol, atol=atol), (
            float(np.abs(a - b).max()) if a.size else 0.0)

    for name, ch, n, rtol, atol, mask in (
            ("pos", G_POS, 3, 1e-3, 5e-4, hit),
            ("norm", G_NORM, 3, 1e-3, 5e-4, hit),
            ("depth", G_DEPTH, 1, 1e-3, 5e-4, hit),
            ("dir", G_DIR, 3, 1e-5, 1e-6, np.ones_like(same))):
        ok, err = close(ch, n, rtol, atol, mask)
        stats[f"{name}_max_abs_err"] = err
        if not ok:
            fails.append(f"{name} outside rtol {rtol} / atol {atol} "
                         f"(max abs err {err:.3g})")
    motion_eq = (gb_ref[G_MOTION] == gb[G_MOTION])[hit]
    stats["motion_match"] = float(motion_eq.mean()) if motion_eq.size else 1.0
    if stats["motion_match"] < MOTION_MATCH_MIN:
        fails.append(f"motion match {stats['motion_match']:.5f} < "
                     f"{MOTION_MATCH_MIN}")
    for name, ch in (("shade", G_SHADE), ("light", G_LIGHT),
                     ("miss", G_MISS)):
        if not np.array_equal(gb_ref[ch][same], gb[ch][same]):
            fails.append(f"{name} mask differs on matched lanes")
    return fails, stats


def pt_report(pt_ref, pt):
    """Compare a pt (reuse) pack against pt_ref: RIS picks, the weights of
    same-pick lanes and their M. Returns (failures, stats)."""
    pt_ref, pt = _np(pt_ref), _np(pt)
    fails = []
    stats = {}
    pick = np.all(pt_ref[P_LI:P_LI + 3] == pt[P_LI:P_LI + 3], axis=0)
    stats["pick_match"] = float(pick.mean())
    if pick.mean() < PICK_MATCH_MIN:
        fails.append(f"pick match {pick.mean():.5f} < {PICK_MATCH_MIN}")
    w_ref, w = pt_ref[P_WEIGHT][pick], pt[P_WEIGHT][pick]
    w_close = np.isclose(w_ref, w, rtol=2e-4, atol=1e-6)
    stats["weight_close"] = float(w_close.mean()) if w_close.size else 1.0
    stats["weight_max_abs_err"] = (float(np.abs(w_ref - w).max())
                                   if w.size else 0.0)
    if stats["weight_close"] < WEIGHT_CLOSE_MIN:
        fails.append(f"weights within rtol 2e-4 on {stats['weight_close']:.5f}"
                     f" < {WEIGHT_CLOSE_MIN} of same-pick lanes")
    # M: a flip of a motion index, of a tile's window start or of a
    # similarity threshold changes which history merges, so M is held
    # to a bounded mismatch rather than bit equality
    m_eq = pt_ref[P_M][pick] == pt[P_M][pick]
    stats["m_match"] = float(m_eq.mean()) if m_eq.size else 1.0
    if stats["m_match"] < M_MATCH_MIN:
        fails.append(f"M equal on {stats['m_match']:.6f} < {M_MATCH_MIN} "
                     "of same-pick lanes")
    return fails, stats


def gb_pt_report(gb_ref, pt_ref, gb, pt):
    """Both reports on one frame's packs. Returns (failures, stats)."""
    fails_g, stats_g = gb_report(gb_ref, gb)
    fails_p, stats_p = pt_report(pt_ref, pt)
    return fails_g + fails_p, {**stats_g, **stats_p}


def close_fraction(ref, got, rtol, atol) -> float:
    """Fraction of elements of `got` within rtol/atol of `ref`."""
    ref, got = _np(ref), _np(got)
    return float(np.isclose(ref, got, rtol=rtol, atol=atol).mean())
