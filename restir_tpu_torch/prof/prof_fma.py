"""The brute-force any hit in two forms at 1920x1080 (random rays in the
headline scene's box against its triangles' plane rows, padded to 512):
a per-lane FP32 FMA loop and tensor-core tiles (wgmma m64n96k8 TF32 on
operands split into TF32 pieces: 3xTF32, 3 products; 6xTF32, 6),
`csrc/prof/anyhit.cu`; each held to its plain twin under the reference's
primitive gate (mismatch <= 0.2 %), the FP32 and 6xTF32 forms to each
other too (3xTF32's mismatch against them is printed: on segments that
end on a surface it is over the gate), beside torch.matmul computing
the same dots.

Port of the TPU probe prof/prof_fma.py: `_mxu_kernel` (dot_f32x3's
bf16-split MXU products, launched at :116) against `_fma_kernel` (the
per-lane VPU form, :139) over 512 padded triangles and 1080p rays.

    python -m restir_tpu_torch.prof fma
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import intersect
from . import _scenes, _timing
from . import kernels as pk

N_PAD = 512  # the TPU probe's padded rows for the headline scene
GATE = 0.002  # the reference's primitive gate: mismatch <= 0.2 %
CHUNK = 131072  # rays per torch.matmul call of the library timing


def random_rays(lo, hi, r, device, seed=0):
    """prof_fma's rays: origins uniform in the box, unit directions,
    limits uniform in [1, 30]; [8, r] (o, d, limit, 0)."""
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, size=(r, 3)).astype(np.float32)
    d = g.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lim = g.uniform(1.0, 30.0, size=r).astype(np.float32)
    pack = np.concatenate([o.T, d.T, lim[None], np.zeros((1, r),
                                                          np.float32)])
    return torch.as_tensor(pack, device=device).contiguous()


def dots_matmul(rays, planes):
    """The six plane dots of every (ray, row) pair by torch.matmul (full
    float32), CHUNK rays a call into one buffer: the library yardstick."""
    r = rays.shape[1]
    a = torch.cat([rays[0:3], torch.ones_like(rays[:1]), rays[3:6],
                   torch.zeros_like(rays[:1])]).T.contiguous()
    b = torch.zeros((8, 6 * planes.shape[0]), device=rays.device)
    for p in range(3):
        b[0:4, p::6] = planes[:, 4 * p:4 * p + 4].T
        b[4:7, 3 + p::6] = planes[:, 4 * p:4 * p + 3].T
    out = torch.empty((min(CHUNK, r), b.shape[1]), device=rays.device)
    for p0 in range(0, r, CHUNK):
        n = min(CHUNK, r - p0)
        torch.matmul(a[p0:p0 + n], b, out=out[:n])
    return out


def run(device="cuda", small=False):
    fr = _scenes.headline(device, small)
    xform = intersect.traversal_arrays(fr.scene, "brute").tri_xform
    planes = pk.plane_rows(xform, N_PAD)
    lo, hi = _scenes.scene_box(fr)
    r = fr.cfg.num_pixels
    rays = random_rays(lo, hi, r, fr.device)
    occ = {f: pk.anyhit(rays, planes, f) for f in pk.ANYHIT_FORMS}
    ref = {f: pk.anyhit_ref(rays, planes,
                            split=None if f == "fma" else int(f[3]))
           for f in pk.ANYHIT_FORMS}
    mis = {f"{f} vs its twin": float((occ[f] != ref[f]).float().mean())
           for f in pk.ANYHIT_FORMS}
    mis["mma6 vs fma"] = float((occ["mma6"] != occ["fma"]).float().mean())
    print(f"probe fma: occluded {float(occ['fma'].float().mean()):.4f} of "
          f"{r} rays; " + ", ".join(f"mismatch {k} {v:.2e}"
                                    for k, v in mis.items())
          + f"; mma3 vs fma (not gated) "
          f"{float((occ['mma3'] != occ['fma']).float().mean()):.2e}",
          flush=True)
    bad = {k: v for k, v in mis.items() if v > GATE}
    if bad:
        raise RuntimeError(f"fma: over the primitive gate: {bad}")
    calls = {f: (lambda f=f: pk.anyhit(rays, planes, f))
             for f in pk.ANYHIT_FORMS}
    if _timing.on_card(device):
        calls["torch.matmul dots"] = lambda: dots_matmul(rays, planes)
    times = _timing.interleaved(calls, device, rounds=2)
    return [_timing.times_row("fma", f"{fr.name}.{k}", v,
                              f"{r} rays x {N_PAD} rows")
            for k, v in times.items()]
