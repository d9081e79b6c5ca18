"""Kernels B3 and B4: one à-trous level (EAW or SVGF), and their plain
twins.

Port of `restir_tpu.ops.pallas.atrous_kernel._atrous_kernel` in `eaw`
mode (`atrous_level_pallas`): 5x5 Gaussian taps at stride 2^level with
colour, normal and position edge stops and primitive rejection
(waveletFilter, denoiser.cu:64-134). The guide channels (prim remap,
normal, position) are read straight from the G-buffer pack, so no
[10, R] concatenation is built per level. Taps run in the reference's
order (rows outer, columns inner) so the sums round the same way.

B4 (`atrous_svgf_level`) is `_atrous_kernel` in `svgf` mode
(waveletFilter, denoiser.cu:139-216): the luminance edge stop divides by
sigma_l * sqrt(prefiltered variance), the normal weight is
max(n.n', 0)^sigma_n (as exp(sigma_n log(.)), the JAX kernel's form),
every weight gets + 1e-4, and the variance is filtered with the squared
weights. It returns colour [3, R] and variance [R].

On the card both kernels stage a 32 x 8 tile and its halo of every
channel in shared memory and sum the taps from there, in the twins'
order; see `csrc/atrous.cu`. They take levels 0 to MAX_LEVEL. For
sigmas in [FAST_MIN, FAST_MAX] they divide by a sigma through div.rn's
fast path with the sigma's reciprocal hoisted out of the taps;
`division_mismatches` checks that against div.rn over every float.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_di import G_NORM, G_POS, G_PRIMR, GB_CH, NULL, _check

launches = 0  # CUDA kernel launches (B3)
svgf_launches = 0  # CUDA kernel launches (B4)
F32_EPS = 1.1920928955078125e-07  # float32 machine epsilon
MAX_LEVEL = 24  # the kernels' widest stride is 2^24 (csrc/atrous.cu)
FAST_MIN, FAST_MAX = 1e-6, 1e6  # sigmas the hoisted division takes

# 5x5 Gaussian (denoiser.cu:11-17)
GAUSSIAN_5 = (
    (0.0030, 0.0133, 0.0219, 0.0133, 0.0030),
    (0.0133, 0.0596, 0.0983, 0.0596, 0.0133),
    (0.0219, 0.0983, 0.1621, 0.0983, 0.0219),
    (0.0133, 0.0596, 0.0983, 0.0596, 0.0133),
    (0.0030, 0.0133, 0.0219, 0.0133, 0.0030),
)


def _shift(plane: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = plane[..., y+dy, x+dx], zero outside."""
    h, w = plane.shape[-2], plane.shape[-1]
    out = torch.zeros_like(plane)
    ys, ye = max(-dy, 0), min(h, h - dy)
    xs, xe = max(-dx, 0), min(w, w - dx)
    if ys < ye and xs < xe:
        out[..., ys:ye, xs:xe] = plane[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


def atrous_level_ref(color, gb, *, level, width, height, sig_l, sig_n,
                     sig_d):
    """Plain PyTorch twin: colour [3, R] -> filtered colour [3, R]."""
    h, w = height, width
    c = color.view(3, h, w)
    prim = gb[G_PRIMR].view(h, w)
    norm = gb[G_NORM:G_NORM + 3].view(3, h, w)
    pos = gb[G_POS:G_POS + 3].view(3, h, w)
    inb = torch.ones((h, w), dtype=torch.float32, device=color.device)
    step = 1 << level
    sum_c = torch.zeros_like(c)
    sum_w = torch.zeros_like(prim)
    for i in range(-2, 3):
        if abs(i) * step >= h:
            continue
        for j in range(-2, 3):
            if abs(j) * step >= w:
                continue
            gk = GAUSSIAN_5[i + 2][j + 2]
            dy, dx = i * step, j * step
            ok = (_shift(inb, dy, dx) > 0.0) & (_shift(prim, dy, dx) == prim)
            cq = _shift(c, dy, dx)
            nq = _shift(norm, dy, dx)
            pq = _shift(pos, dy, dx)
            d2c = ((c[0] - cq[0]) ** 2 + (c[1] - cq[1]) ** 2
                   + (c[2] - cq[2]) ** 2)
            d2n = ((norm[0] - nq[0]) ** 2 + (norm[1] - nq[1]) ** 2
                   + (norm[2] - nq[2]) ** 2)
            d2p = ((pos[0] - pq[0]) ** 2 + (pos[1] - pq[1]) ** 2
                   + (pos[2] - pq[2]) ** 2)
            wc = torch.clamp(torch.exp(-d2c / sig_l), max=1.0)
            wn = torch.clamp(torch.exp(-d2n / sig_n), max=1.0)
            wp = torch.clamp(torch.exp(-d2p / sig_d), max=1.0)
            weight = torch.where(ok, wc * wn * wp * gk, 0.0)
            sum_c = sum_c + cq * weight[None]
            sum_w = sum_w + weight
    keep = (sum_w == 0.0) | (prim <= NULL)
    out = sum_c / torch.clamp(sum_w, min=1e-20)[None]
    return torch.where(keep[None], c, out).reshape(3, h * w)


def _check_level(level):
    if not 0 <= level <= MAX_LEVEL:
        raise ValueError(f"level {level} outside [0, {MAX_LEVEL}]")


def atrous_level_cuda(color, gb, *, level, width, height, sig_l, sig_n,
                      sig_d):
    """Launch the B3 kernel of `csrc/atrous.cu` for one level."""
    global launches
    r = width * height
    dev = color.device
    _check_level(level)
    _check(color, "color", (3, r), dev)
    _check(gb, "gb", (GB_CH, r), dev)
    out = torch.empty_like(color)
    lib = _build.library()
    p = _build.ptr
    with _build.on_device(dev):
        err = lib.restir_atrous_eaw(
            p(color), p(gb), p(out), width, height, level,
            ctypes.c_float(sig_l), ctypes.c_float(sig_n),
            ctypes.c_float(sig_d), _build.stream_of(dev))
    _build.check(err, "restir_atrous_eaw")
    launches += 1
    return out


def atrous_level(color, gb, *, level, width, height, sig_l, sig_n, sig_d):
    """One EAW level: colour [3, R] -> [3, R]. CPU tensors take the plain
    twin, CUDA tensors the kernel."""
    kw = dict(level=level, width=width, height=height, sig_l=sig_l,
              sig_n=sig_n, sig_d=sig_d)
    if color.device.type == "cpu":
        return atrous_level_ref(color, gb, **kw)
    if color.device.type == "cuda":
        return atrous_level_cuda(color, gb, **kw)
    raise ValueError(f"unsupported device {color.device}")


def _lum(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def atrous_svgf_ref(color, var, fv, gb, *, level, width, height, sig_l,
                    sig_n, sig_d):
    """Plain twin of B4: colour [3, R], variance [R], prefiltered
    variance [R] -> (colour [3, R], variance [R])."""
    h, w = height, width
    c = color.view(3, h, w)
    v = var.view(h, w)
    f = fv.view(h, w)
    prim = gb[G_PRIMR].view(h, w)
    norm = gb[G_NORM:G_NORM + 3].view(3, h, w)
    pos = gb[G_POS:G_POS + 3].view(3, h, w)
    inb = torch.ones((h, w), dtype=torch.float32, device=color.device)
    step = 1 << level
    lum_p = _lum(c)
    sum_c = torch.zeros_like(c)
    sum_w = torch.zeros_like(prim)
    sum_v = torch.zeros_like(prim)
    sum_w2 = torch.zeros_like(prim)
    for i in range(-2, 3):
        if abs(i) * step >= h:
            continue
        for j in range(-2, 3):
            if abs(j) * step >= w:
                continue
            gk = GAUSSIAN_5[i + 2][j + 2]
            dy, dx = i * step, j * step
            ok = (_shift(inb, dy, dx) > 0.0) & (_shift(prim, dy, dx) == prim)
            cq = _shift(c, dy, dx)
            nq = _shift(norm, dy, dx)
            pq = _shift(pos, dy, dx)
            d2p = ((pos[0] - pq[0]) ** 2 + (pos[1] - pq[1]) ** 2
                   + (pos[2] - pq[2]) ** 2)
            wp = torch.exp(-d2p / sig_d) + 1e-4
            ndot = torch.clamp(norm[0] * nq[0] + norm[1] * nq[1]
                               + norm[2] * nq[2], min=0.0)
            wn = torch.exp(sig_n * torch.log(torch.clamp(ndot, min=1e-30)))
            wn = wn + 1e-4
            denom = sig_l * torch.sqrt(torch.clamp(_shift(f, dy, dx),
                                                   min=0.0)) + 1e-4
            wc = torch.exp(-torch.abs(lum_p - _lum(cq)) / denom) + 1e-4
            weight = torch.where(ok, wc * wn * wp * gk, 0.0)
            w2 = weight * weight
            sum_v = sum_v + _shift(v, dy, dx) * w2
            sum_w2 = sum_w2 + w2
            sum_c = sum_c + cq * weight[None]
            sum_w = sum_w + weight
    keep = (sum_w < F32_EPS) | (prim <= NULL)
    out_c = sum_c / torch.clamp(sum_w, min=1e-20)[None]
    out_v = sum_v / torch.clamp(sum_w2, min=1e-20)
    return (torch.where(keep[None], c, out_c).reshape(3, h * w),
            torch.where(keep, v, out_v).reshape(h * w))


def atrous_svgf_cuda(color, var, fv, gb, *, level, width, height, sig_l,
                     sig_n, sig_d):
    """Launch B4 (`atrous_svgf_kernel` of `csrc/atrous.cu`)."""
    global svgf_launches
    r = width * height
    dev = color.device
    _check_level(level)
    _check(color, "color", (3, r), dev)
    _check(var, "var", (r,), dev)
    _check(fv, "fv", (r,), dev)
    _check(gb, "gb", (GB_CH, r), dev)
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    p = _build.ptr
    lib = _build.library()
    with _build.on_device(dev):
        err = lib.restir_atrous_svgf(
            p(color), p(var), p(fv), p(gb), p(out), width, height, level,
            ctypes.c_float(sig_l), ctypes.c_float(sig_n),
            ctypes.c_float(sig_d), _build.stream_of(dev))
    _build.check(err, "restir_atrous_svgf")
    svgf_launches += 1
    return out[0:3], out[3]


def atrous_svgf_level(color, var, fv, gb, *, level, width, height, sig_l,
                      sig_n, sig_d):
    """One SVGF level: (colour [3, R], variance [R]). CPU tensors take the
    plain twin, CUDA tensors the kernel."""
    kw = dict(level=level, width=width, height=height, sig_l=sig_l,
              sig_n=sig_n, sig_d=sig_d)
    if color.device.type == "cpu":
        return atrous_svgf_ref(color, var, fv, gb, **kw)
    if color.device.type == "cuda":
        return atrous_svgf_cuda(color, var, fv, gb, **kw)
    raise ValueError(f"unsupported device {color.device}")


def division_mismatches(sig, device) -> int:
    """On the card: how many floats d >= 0 give expf(-d / sig) other bits
    through the kernels' hoisted division than through div.rn (NaN
    agrees with NaN). The kernels take the hoisted division for sigmas
    in [FAST_MIN, FAST_MAX]; there it must be 0."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    err = _build.library().restir_atrous_div_check(
        ctypes.c_float(sig), _build.ptr(count), _build.stream_of(device))
    _build.check(err, "restir_atrous_div_check")
    return int(count.item())
