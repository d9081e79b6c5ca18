"""Vector math of the port, as `restir_tpu.utils.math` (mathUtil.h:27-198).

Vectors are tensors with a trailing component axis ([..., 3]).

Rounding. Run op by op, the JAX package rounds every product and sum on
its own, and sums a reduction left to right. Inside code that XLA
compiles for the CPU (its jitted functions, `lax.map`, `lax.scan`,
`fori_loop` bodies) it contracts a product feeding a sum into one fused
multiply-add: for `p + q` it fuses p when p is a product used once, else
q, and `sum(a * b)` becomes fma(a2, b2, fma(a1, b1, a0 b0)). On CPU
tensors the port mirrors this so the two agree lane for lane where a
branch turns on the last bit: the helpers below round plainly, or fused
inside a `with fused():` block (the port wraps exactly the code the JAX
package compiles), and `cross` / `norm` always fused (`jnp.cross` and
`jnp.linalg.norm` are jitted). CUDA tensors, which nothing holds lane
for lane against XLA, take the plain float32 ops in every case.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

PI = 3.1415926535897932384626433832795
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI


_FUSED = contextvars.ContextVar("restir_fused_rounding", default=False)


@contextlib.contextmanager
def fused():
    """Round the helpers' multiply-adds on CPU tensors as XLA's compiled
    CPU code does."""
    token = _FUSED.set(True)
    try:
        yield
    finally:
        _FUSED.reset(token)


def _mirror(*xs, always=False) -> bool:
    """Whether a helper on these operands rounds as XLA's compiled CPU
    code: inside `fused()` (or `always`), and never on the card."""
    t = next(x for x in xs if isinstance(x, torch.Tensor))
    return not t.is_cuda and (always or _FUSED.get())


def fma(a, b, c):
    """a * b + c rounded once to float32, exactly through float64 (the
    product is exact there): XLA's CPU contraction, for CPU tensors.
    On the card it is the plain a * b + c."""
    if not _mirror(a, b, c, always=True):
        return a * b + c
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) if not
               isinstance(x, torch.Tensor) else x.double() for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def matmul_f32(a, b):
    """a @ b in full float32. PyTorch's default matmul precision
    ("highest") keeps TF32 off on the card; the ray tests need it so."""
    if a.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("restir_tpu_torch needs full float32 matmuls: "
                           "torch.set_float32_matmul_precision('highest')")
    return a @ b


def muladd(a, b, c):
    """a * b + c, fused inside a `fused()` block on the CPU."""
    return fma(a, b, c) if _mirror(a, b, c) else a * b + c


def _chain(a, b):
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def dot(a, b):
    """Sum over the last axis of a * b (left to right, or the fused
    chain inside `fused()` on the CPU)."""
    if _mirror(a):
        return _chain(a, b)
    p = a * b
    acc = p[..., 0]
    for i in range(1, p.shape[-1]):
        acc = acc + p[..., i]
    return acc


def norm(v):
    """|v| as `jnp.linalg.norm` rounds it: on the CPU a fused chain and a
    correctly rounded square root (taken in float64: PyTorch's vectorised
    float32 sqrt on the CPU can miss the nearest float by an ulp)."""
    if _mirror(v, always=True):
        return torch.sqrt(_chain(v, v).double()).to(torch.float32)
    return torch.sqrt(dot(v, v))


def sat_dot(a, b):
    """max(dot(a, b), 0) — mathUtil.h:64."""
    return torch.clamp(dot(a, b), min=0.0)


def abs_dot(a, b):
    """|dot(a, b)| — mathUtil.h:68."""
    return torch.abs(dot(a, b))


def length(v):
    return torch.sqrt(dot(v, v))


def safe_normalize(v):
    return v / torch.clamp(length(v), min=1e-20)[..., None]


def cross(a, b):
    """a x b, each component fma(a_i, b_j, -(a_j b_i)) on the CPU."""
    a, b = torch.broadcast_tensors(a, b)
    mirror = _mirror(a, always=True)

    def comp(i, j):
        if not mirror:
            return a[..., i] * b[..., j] - a[..., j] * b[..., i]
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def weighted3(x, wx, y, wy, z, wz):
    """x wx + y wy + z wz (fused on the CPU: fma(z, wz, fma(x, wx,
    y wy)))."""
    if _mirror(x):
        return fma(z, wz, fma(x, wx, y * wy))
    return x * wx + y * wy + z * wz


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def square(x):
    return x * x


def mix(a, b, t):
    """a (1 - t) + b t."""
    return muladd(a, 1.0 - t, b * t)


def power_heuristic(f, g):
    """Two-sample power heuristic (beta = 2) — mathUtil.h:81."""
    f2 = f * f
    return f2 / muladd(g, g, f2)


def luminance(c):
    """Rec.709 luminance — mathUtil.h:119."""
    return weighted3(c[..., 0], 0.2126, c[..., 1], 0.7152, c[..., 2], 0.0722)


def _calc_filmic(c):
    return ((c * (c * 0.22 + 0.03) + 0.002)
            / (c * (c * 0.22 + 0.3) + 0.06) - 1.0 / 30.0)


def filmic(c: torch.Tensor) -> torch.Tensor:
    """Hable filmic tonemap."""
    white = _calc_filmic(torch.tensor(11.2, dtype=torch.float32))
    return _calc_filmic(c * 1.6) / white.to(c.device)


def aces(c: torch.Tensor) -> torch.Tensor:
    """ACES approximation."""
    return (c * (c * 2.51 + 0.03)) / (c * (c * 2.43 + 0.59) + 0.14)


def correct_gamma(c: torch.Tensor) -> torch.Tensor:
    """Gamma 2.2 encode."""
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def trunc_i32(x):
    """float -> int32 toward zero, saturating, NaN -> 0 (XLA's convert and
    PTX cvt.rzi.s32.f32)."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -2147483648.0,
                    2147483648.0)
    return torch.clamp(x.to(torch.int64), -2147483648,
                       2147483647).to(torch.int32)


def is_nan_or_inf(x):
    return torch.isnan(x) | torch.isinf(x)


def has_nan_or_inf(v):
    """True where a vector (the last axis) has a NaN / Inf component."""
    return is_nan_or_inf(v).any(dim=-1)


def zero_nan_or_inf(v):
    """Zero every vector with a NaN / Inf component (restir.cu:224-226)."""
    return torch.where(has_nan_or_inf(v)[..., None], 0.0, v)


def cumsum(x):
    """Inclusive prefix sum over the last axis in the order of JAX's
    `associative_scan` (its CPU `cumsum`): pairs are summed, the odd
    positions scanned recursively, the even ones filled in from them."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = cumsum(x[..., 0:n - 1:2] + x[..., 1::2])
    if n % 2 == 0:
        even = odd[..., :-1] + x[..., 2::2]
    else:
        even = odd + x[..., 2::2]
    even = torch.cat([x[..., :1], even], dim=-1)
    out = torch.empty_like(x)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def triangle_area(v0, v1, v2):
    return length(cross(v1 - v0, v2 - v0)) * 0.5


def triangle_normal(v0, v1, v2):
    return safe_normalize(cross(v1 - v0, v2 - v0))


def sample_triangle_uniform(v0, v1, v2, ru, rv):
    """Uniform area sampling — mathUtil.h:94 (sqrt warp)."""
    r = torch.sqrt(rv)
    u = 1.0 - r
    v = ru * r
    return weighted3(v1, u[..., None], v2, v[..., None], v0,
                     (1.0 - u - v)[..., None])


def to_concentric_disk(x, y):
    """[0, 1)^2 -> disk, polar warp — mathUtil.h:128."""
    r = torch.sqrt(x)
    theta = y * TWO_PI
    return torch.stack([torch.cos(theta) * r, torch.sin(theta) * r], dim=-1)


def to_sphere(uv):
    """Equirect [0, 1]^2 -> unit direction — mathUtil.h:134."""
    phi = uv[..., 0] * TWO_PI
    theta = uv[..., 1] * PI
    st = torch.sin(theta)
    return torch.stack([torch.cos(phi) * st, torch.cos(theta),
                        torch.sin(phi) * st], dim=-1)


def to_plane(v):
    """Unit direction -> equirect uv — mathUtil.h:139."""
    u = torch.atan2(v[..., 2], v[..., 0]) * INV_PI * 0.5 + 1.0
    u = u - torch.floor(u)
    w = torch.atan2(torch.sqrt(muladd(v[..., 0], v[..., 0],
                                      v[..., 2] * v[..., 2])),
                    v[..., 1]) * INV_PI
    return torch.stack([u, w], dim=-1)


def local_ref_frame(n):
    """Tangent frame (t, b) around n — mathUtil.h:146: helper (0, 0, 1)
    when |n.y| > 0.9999 else (0, 1, 0); b = normalize(n x helper);
    t = b x n."""
    cond = (torch.abs(n[..., 1]) > 0.9999)[..., None]
    z = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    helper = torch.where(cond, z, y)
    b = safe_normalize(cross(n, helper))
    t = cross(b, n)
    return t, b


def local_to_world(n, v):
    """mathUtil.h:153 — rotate local vector v into the frame of n."""
    t, b = local_ref_frame(n)
    return safe_normalize(weighted3(t, v[..., 0:1], b, v[..., 1:2], n,
                                    v[..., 2:3]))


def sample_hemisphere_cosine(n, rx, ry):
    """Cosine-weighted hemisphere direction about n — mathUtil.h:157."""
    d = to_concentric_disk(rx, ry)
    z = torch.sqrt(torch.clamp(1.0 - dot(d, d), min=0.0))
    return local_to_world(n, torch.cat([d, z[..., None]], dim=-1))


def refract(n, wi, ior):
    """Snell refraction — mathUtil.h:163. Returns (ok, wt)."""
    cos_in = dot(n, wi)
    ior = torch.where(cos_in < 0, 1.0 / ior, ior)
    sin2_in = torch.clamp(muladd(-cos_in, cos_in, 1.0), min=0.0)
    sin2_tr = sin2_in / (ior * ior)
    ok = sin2_tr < 1.0
    cos_tr = torch.sqrt(torch.clamp(1.0 - sin2_tr, min=0.0))
    cos_tr = torch.where(cos_in < 0, -cos_tr, cos_tr)
    wt = safe_normalize(muladd(n, ((cos_in / ior) - cos_tr)[..., None],
                               -wi / ior[..., None]))
    return ok, wt


def pdf_area_to_solid_angle(pdf, x, y, ny):
    """Area-measure pdf at y (normal ny) seen from x — mathUtil.h:182."""
    yx = x - y
    d2 = dot(yx, yx)
    return pdf * d2 / torch.clamp(abs_dot(ny, safe_normalize(yx)), min=1e-20)
