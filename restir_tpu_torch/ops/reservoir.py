"""Weighted reservoir resampling over per-pixel tensors, as
`restir_tpu.ops.reservoir` (restir.h:29-126).

A reservoir is a NamedTuple of [R]-leading tensors: the sample payload
(a NamedTuple of tensors), the cumulative weight and the candidate count
M. Every operation is a masked lane-wise select. `check_validity` zeroes
(weight, M) wherever the weight is NaN, Inf or negative, so a NaN never
enters the reuse chain (restir.h:51-59).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils import math as mathx


class Reservoir(NamedTuple):
    sample: Any  # NamedTuple of [R, ...] tensors
    weight: torch.Tensor  # [R] float32 cumulative resampling weight
    m: torch.Tensor  # [R] int32 candidates seen


class DirectSample(NamedTuple):
    """DirectLiSample — restir.h:7-11."""

    li: torch.Tensor  # [R, 3]
    wi: torch.Tensor  # [R, 3]
    dist: torch.Tensor  # [R]


class IndirectSample(NamedTuple):
    """IndirectLiSample — restir.h:13-27."""

    lo: torch.Tensor  # [R, 3]
    xv: torch.Tensor  # [R, 3]
    nv: torch.Tensor  # [R, 3]
    xs: torch.Tensor  # [R, 3]
    ns: torch.Tensor  # [R, 3]


def tree_leaves(tree):
    """Leaves of nested tuples / NamedTuples in JAX's flatten order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(template, leaves):
    """Inverse of tree_leaves against a template of the same structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            parts = [build(s) for s in t]
            return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
        return next(it)

    return build(template)


def tree_map(fn, *trees):
    leaves = [tree_leaves(t) for t in trees]
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*leaves)])


def zeros_direct(r: int, device="cuda") -> Reservoir:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Reservoir(sample=DirectSample(li=z(r, 3), wi=z(r, 3), dist=z(r)),
                     weight=z(r),
                     m=torch.zeros((r,), dtype=torch.int32, device=device))


def zeros_indirect(r: int, device="cuda") -> Reservoir:
    def z3():
        return torch.zeros((r, 3), dtype=torch.float32, device=device)

    return Reservoir(
        sample=IndirectSample(lo=z3(), xv=z3(), nv=z3(), xs=z3(), ns=z3()),
        weight=torch.zeros((r,), dtype=torch.float32, device=device),
        m=torch.zeros((r,), dtype=torch.int32, device=device))


def _select_sample(take, new_sample, old_sample):
    def sel(new, old):
        return torch.where(take.reshape(take.shape + (1,) * (new.dim()
                                                             - take.dim())),
                           new, old)

    return tree_map(sel, new_sample, old_sample)


def update(res: Reservoir, new_sample, new_weight, r,
           active=None) -> Reservoir:
    """Streaming WRS update — restir.h:38-44. Inactive lanes unchanged."""
    if active is None:
        active = torch.ones_like(new_weight, dtype=torch.bool)
    weight = torch.where(active, res.weight + new_weight, res.weight)
    m = torch.where(active, res.m + 1, res.m)
    take = active & (r * weight < new_weight)
    return Reservoir(sample=_select_sample(take, new_sample, res.sample),
                     weight=weight, m=m)


def merge(a: Reservoir, b: Reservoir, r, active=None) -> Reservoir:
    """a.merge(b, r) — restir.h:61-68. Inactive lanes keep a."""
    if active is None:
        active = torch.ones_like(a.weight, dtype=torch.bool)
    weight = torch.where(active, a.weight + b.weight, a.weight)
    m = torch.where(active, a.m + b.m, a.m)
    take = active & (r * weight < b.weight)
    return Reservoir(sample=_select_sample(take, b.sample, a.sample),
                     weight=weight, m=m)


def clamp(res: Reservoir, limit) -> Reservoir:
    """M cap: scale the weight by limit / M where M > limit —
    restir.h:88-93."""
    limit = torch.as_tensor(limit, dtype=torch.int32, device=res.m.device)
    over = res.m > limit
    scale = (limit.to(torch.float32)
             / torch.clamp(res.m, min=1).to(torch.float32))
    return res._replace(weight=torch.where(over, res.weight * scale,
                                           res.weight),
                        m=torch.where(over, limit, res.m))


def pre_clamped_merge(a: Reservoir, b: Reservoir, cap: int, r,
                      active=None) -> Reservoir:
    """a.preClampedMerge<cap>(b, r) — restir.h:95-102."""
    limit = torch.where(a.m > 0, (cap - 1) * a.m, b.m)
    return merge(a, clamp(b, limit), r, active=active)


def post_clamped_merge(a: Reservoir, b: Reservoir, cap: int, r,
                       active=None) -> Reservoir:
    """a.postClampedMerge<cap>(b, r) — restir.h:104-112."""
    merged = merge(a, b, r, active=active)
    do = (merged.m > 0) & (a.m > 0)
    return clamp(merged, torch.where(do, cap * a.m, merged.m))


def invalid(res: Reservoir) -> torch.Tensor:
    """NaN / Inf / negative cumulative weight — restir.h:51-53."""
    return mathx.is_nan_or_inf(res.weight) | (res.weight < 0.0)


def check_validity(res: Reservoir) -> Reservoir:
    """Zero (weight, M) on invalid lanes — restir.h:55-59."""
    bad = invalid(res)
    return res._replace(weight=torch.where(bad, 0.0, res.weight),
                        m=torch.where(bad, 0, res.m))


def gather(res: Reservoir, idx) -> Reservoir:
    """Every leaf indexed by a [R] pixel index (already clipped)."""
    idx = idx.long()
    return tree_map(lambda leaf: leaf[idx], res)


def take_columns(pack: torch.Tensor, index, base: int = 0) -> torch.Tensor:
    """Columns of a [C, n] pack that holds global pixels base .. base + n
    at the global pixel indices `index` ([R]), each clipped into the
    held range (the callers mask the lanes whose index is invalid)."""
    return pack[:, torch.clamp(index.long() - base, 0, pack.shape[1] - 1)]


def pack_channels(tree) -> torch.Tensor:
    """Leaves of [R] / [R, k] tensors -> one channel-major [C, R] float32
    matrix (leaf order)."""
    rows = []
    for leaf in tree_leaves(tree):
        leaf = leaf.to(torch.float32)
        rows.append(leaf[None] if leaf.dim() == 1 else leaf.T)
    return torch.cat(rows, dim=0)


def unpack_channels(chans, template):
    """Inverse of pack_channels against a template (shapes, dtypes)."""
    out, c = [], 0
    for leaf in tree_leaves(template):
        k = 1 if leaf.dim() == 1 else leaf.shape[-1]
        row = chans[c:c + k]
        out.append((row[0] if leaf.dim() == 1 else row.T).to(leaf.dtype))
        c += k
    return tree_unflatten(template, out)
