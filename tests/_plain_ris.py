"""A plain formulation of the RIS twin's light targets and CDF, kept apart
from the kernels' rounding, for the tests that hold the twin and the
search against an independent reference.

`fused_di.ris_targets` rounds its light targets as the CUDA builds do (the
FMA fusion of `csrc/di_core.cuh`'s `light_target4`) and `fused_di.cdf_rows`
adds the CDF in row order, as the kernels scan it. `plain_targets` is the
same function written as plain float32 products and sums (the JAX
package's `_ris_select_core` expressions, op by op), and `plain_cdf` is
`torch.cumsum`; `plain_twin` swaps both into the twin.
"""

import contextlib

import torch

from restir_tpu_torch.ops.kernels import fused_di
from restir_tpu_torch.ops.kernels.fused_di import (
    DIELECTRIC,
    G_DIR,
    G_MTYPE,
    G_NORM,
    G_POS,
)


def plain_targets(gb, psi, single_sided):
    """(shading normal facing wo unless dielectric, light targets [b,
    l_pad]) with every product and sum rounded on its own."""
    px, py, pz = gb[G_POS], gb[G_POS + 1], gb[G_POS + 2]
    nx, ny, nz = gb[G_NORM], gb[G_NORM + 1], gb[G_NORM + 2]
    wox, woy, woz = -gb[G_DIR], -gb[G_DIR + 1], -gb[G_DIR + 2]
    ndotwo = nx * wox + ny * woy + nz * woz
    flip = (gb[G_MTYPE] != DIELECTRIC) & (ndotwo < 0.0)
    sgn = torch.where(flip, -1.0, 1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    ndx = nx * px + ny * py + nz * pz
    a = (psi[:, 0][None] * nx[:, None] + psi[:, 1][None] * ny[:, None]
         + psi[:, 2][None] * nz[:, None] + psi[:, 3][None] * (-ndx)[:, None])
    bb = (psi[:, 4][None] * px[:, None] + psi[:, 5][None] * py[:, None]
          + psi[:, 6][None] * pz[:, None] + psi[:, 7][None])
    x2 = px * px + py * py + pz * pz
    d2 = (psi[:, 8][None] * (-2.0 * px)[:, None]
          + psi[:, 9][None] * (-2.0 * py)[:, None]
          + psi[:, 10][None] * (-2.0 * pz)[:, None]
          + psi[:, 11][None] + psi[:, 12][None] * x2[:, None])
    d2 = torch.clamp(d2, min=1e-8)
    side = bb > 0.0 if single_sided else torch.abs(bb) > 0.0
    lum_area = psi[:, 13][None]
    rad = psi[:, 14][None]
    above = (a + rad) > 0.0
    a_eff = torch.maximum(a, 0.1 * rad)
    t = torch.where(above & side,
                    lum_area * a_eff * torch.abs(bb) / (d2 * d2), 0.0)
    return (nx, ny, nz), t


def plain_cdf(t):
    """torch.cumsum along the rows (float64 accumulation on the CPU)."""
    return torch.cumsum(t, dim=1)


@contextlib.contextmanager
def plain_twin():
    """The twin (`fused_di.ris_pixels` and every wrapper's plain version
    built on it) on `plain_targets` and `plain_cdf` inside the block."""
    saved = fused_di.ris_targets, fused_di.cdf_rows
    fused_di.ris_targets, fused_di.cdf_rows = plain_targets, plain_cdf
    try:
        yield
    finally:
        fused_di.ris_targets, fused_di.cdf_rows = saved
