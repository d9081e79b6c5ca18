"""Alias-table discrete sampler, as `restir_tpu.scene.alias_table`.

The build runs on the host in numpy (float64 weights, the reference's
two-stack construction, sampler.h:79-121) and stores float32
probabilities and int32 aliases, bit-equal to the JAX package's tables.
`sample_alias` is the O(1) two-uniform lookup (sampler.h:203-207) on
tensors:

    pass_id = min(int(L * r1), L - 1)
    return pass_id if r2 < prob[pass_id] else fail_id[pass_id]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AliasTable(NamedTuple):
    prob: np.ndarray  # [L] float32 acceptance probability of slot i
    fail_id: np.ndarray  # [L] int32 alias when rejected
    sum_all: float  # total (unnormalised) weight


def build_alias_table(values) -> AliasTable:
    """Build from unnormalised non-negative weights (host, numpy)."""
    values = np.asarray(values, np.float64)
    n = len(values)
    if n == 0:
        return AliasTable(np.zeros((0,), np.float32),
                          np.zeros((0,), np.int32), 0.0)
    sum_all = float(values.sum())
    if sum_all <= 0:
        raise ValueError("alias table requires positive total weight")
    scaled = values * (n / sum_all)

    prob = np.zeros(n, np.float64)
    fail = np.arange(n, dtype=np.int64)
    # the two stacks, popped from the end in the JAX build's order
    gt = [(v, i) for i, v in enumerate(scaled) if v > 1.0]
    ls = [(v, i) for i, v in enumerate(scaled) if v <= 1.0]
    while gt and ls:
        gv, gi = gt.pop()
        lv, li = ls.pop()
        prob[li] = lv
        fail[li] = gi
        gv -= 1.0 - lv
        if gv > 1.0:
            gt.append((gv, gi))
        else:
            ls.append((gv, gi))
    for _, i in gt + ls:
        prob[i] = 1.0
        fail[i] = i
    return AliasTable(prob.astype(np.float32), fail.astype(np.int32),
                      sum_all)


def sample_alias(table_prob: torch.Tensor, table_fail: torch.Tensor, r1, r2):
    """One draw per lane from uniforms r1, r2 -> int64 indices."""
    n = table_prob.shape[0]
    pass_id = torch.clamp((r1 * n).to(torch.int32), max=n - 1).long()
    accept = r2 < table_prob[pass_id]
    return torch.where(accept, pass_id, table_fail[pass_id].long())
