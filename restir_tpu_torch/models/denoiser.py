"""SVGF variance passes, as `restir_tpu.models.denoiser`.

`svgf_estimate_variance` (estimateVariance, denoiser.cu:307-343) and
`svgf_filter_variance` (filterVariance, denoiser.cu:345-371) on planes, in
plain PyTorch: the twins of the two variance kernels in `csrc/svgf.cu`,
which `ops.kernels.svgf` launches for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops.kernels.atrous import _shift

SVGF_ALPHA = 0.2  # denoiser.cu:256
SVGF_HISTORY_THRESHOLD = 3.5  # denoiser.cu:317

# 3x3 Gaussian, denoiser.cu:19-23 (float32 values)
GAUSSIAN_3 = (
    (0.075, 0.124, 0.075),
    (0.124, 0.204, 0.124),
    (0.075, 0.124, 0.075),
)


def svgf_estimate_variance(moment_chw: torch.Tensor) -> torch.Tensor:
    """Variance [H, W] from the moments (E[lum], E[lum^2], history) [3, H,
    W]: temporal where the history is over 3.5 frames, else from the 3x3
    spatial moment means."""
    m1, m2, hist = moment_chw[0], moment_chw[1], moment_chw[2]
    temporal_var = m2 - m1 * m1
    inb = torch.ones_like(m1)
    s1 = torch.zeros_like(m1)
    s2 = torch.zeros_like(m1)
    cnt = torch.zeros_like(m1)
    for i in range(-1, 2):
        for j in range(-1, 2):
            s1 = s1 + _shift(m1, i, j)
            s2 = s2 + _shift(m2, i, j)
            cnt = cnt + _shift(inb, i, j)
    mean = s1 / cnt
    spatial_var = s2 / cnt - mean * mean
    return torch.where(hist > SVGF_HISTORY_THRESHOLD, temporal_var,
                       spatial_var)


def svgf_filter_variance(var: torch.Tensor) -> torch.Tensor:
    """3x3 Gaussian prefilter of the variance [H, W], normalised by the
    in-frame weights."""
    inb = torch.ones_like(var)
    s = torch.zeros_like(var)
    sw = torch.zeros_like(var)
    for i in range(-1, 2):
        for j in range(-1, 2):
            g = GAUSSIAN_3[i + 1][j + 1]
            s = s + _shift(var, i, j) * g
            sw = sw + _shift(inb, i, j) * g
    return s / torch.clamp(sw, min=1e-20)
