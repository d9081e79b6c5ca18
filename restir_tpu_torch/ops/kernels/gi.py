"""Kernels B8 (ReSTIR GI path trace) and B9 (GI resolve), with their
plain PyTorch twins.

Ports of `restir_tpu.ops.pallas.gi_kernel`:
- B8 `_gi_trace_kernel` (`gi_trace_pallas`): one indirect path sample per
  pixel from the primary hit. Per bounce: NEE from depth 2 (alias-table
  light pick, shadow ray, MIS), a BSDF sample (Lambert, GGX-VNDF metal,
  dielectric), the closest hit, light hits with MIS. In: the [IN_CH, R]
  pack; out: the [GO_CH, R] pack (Lo, nv, xs, ns, first-bounce pdf and
  delta flag). `zero_nan_or_inf(Lo)` and the sample's validity are the
  caller's (`models.restir_gi`), as in the JAX package.
- B9 `_gi_resolve_kernel` (`gi_resolve_pallas`): the RIS update of an
  empty reservoir, the temporal merge with the previous frame's resolve
  pack inside each 1024-pixel tile's 2048-pixel window, the M cap and
  the demodulated shade. Returns (indirect [3, R], the next [Q_CH, R]
  pack); the previous pack is only read, never written. A row band of
  whole tiles (`restir_tpu_torch.parallel`) passes `pix0` (its first
  global pixel: the key of its draws), the range of the previous pack
  its motion indices reach, with that range's first global pixel
  `prev_base`, and the previous frame's global pixel count `r_prev`,
  which clips each tile's window start as on one device.

CUDA tensors launch `csrc/gi_trace.cu` / `csrc/gi_resolve.cu`; CPU
tensors take the twins, and nothing falls back. `gi_trace_ref` is
`models.restir_gi`'s torch bounce loop on the IN pack with the plain
brute-force intersections (every triangle row), which B8's MTBVH walks
(`scene.bvh`) equal; `gi_resolve_ref` is B9's function in torch, window
included. The kernels round as the twins do on the card (see
`csrc/gi_core.cuh`), so the two agree there lane for lane.

Pack layouts are the JAX package's channel indices, as flat [C, R].
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_di import SMEM_MAX, eval_bsdf_lum

trace_launches = 0  # B8 launches
resolve_launches = 0  # B9 launches

# ---- trace input pack ([IN_CH, R], gi_kernel.py:68-76)
IN_POS = 0  # 3: primary hit position
IN_NORM = 3  # 3: primary interpolated normal
IN_DIR = 6  # 3: primary ray direction
IN_MTYPE = 9
IN_METAL = 10
IN_ROUGH = 11
IN_IOR = 12
IN_ALIVE = 13  # it.valid & (mat.type != LIGHT)
IN_CH = 16

# ---- trace output pack ([GO_CH, R], :79-85)
GO_LO = 0  # 3
GO_NV = 3  # 3: the flipped primary normal
GO_XS = 6  # 3
GO_NS = 9  # 3
GO_PDF = 12  # primary-bounce pdf
GO_DELTA = 13  # primary bounce was a delta lobe
GO_CH = 16

# ---- resolve pack carried between frames ([Q_CH, R], :119-129)
Q_LO = 0  # 3
Q_XV = 3  # 3
Q_NV = 6  # 3
Q_XS = 9  # 3
Q_NS = 12  # 3
Q_W = 15
Q_M = 16
Q_PRIM = 17
Q_GNORM = 18  # 3
Q_DEPTH = 21
Q_CH = 24  # 22 used

# ---- per-frame G-buffer rows of the resolve ([GQ_CH, R], :132-138)
GQ_MOTION = 0
GQ_PRIM = 1
GQ_DEPTH = 2
GQ_NORM = 3  # 3
GQ_ALB = 6  # 3
GQ_SHADE = 9  # it.valid & (gb.prim_id != LIGHT_ID)
GQ_CH = 10

# GI pass RNG counters and salt (restir_gi.py:46-48, gi_kernel.py:111-114)
CTR_UPDATE = 0
CTR_TEMPORAL = 1
CTR_PATH = 2  # two slots (NEE 4D, BSDF 3D) per bounce
SALT_GI = 0x04

TILE = 1024  # pixels per resolve tile
WINDOW = 2048  # temporal window (pixels) per tile
NULL_PRIM = -1.0
MAX_TRIS = 1024  # the JAX GI gate (restir_gi.py:56-68) B8 is held to


def _check(t, name, channels, r, dev):
    if (t.device != dev or t.dtype != torch.float32
            or tuple(t.shape) != (channels, r)):
        raise ValueError(f"{name}: expected float32 [{channels}, {r}] on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


# ---------------------------------------------------------------------------
# B8


def gi_trace(in_pack, looper, scene, *, depth, single_sided, n_lights,
             pix0=0, has_met=True, has_die=True, has_proc=True):
    """The [GO_CH, R] trace pack of `in_pack` on `scene` (a
    `SceneTensors`); pixel p draws its streams as pixel pix0 + p."""
    kw = dict(depth=depth, single_sided=single_sided, n_lights=n_lights,
              pix0=pix0, has_met=has_met, has_die=has_die,
              has_proc=has_proc)
    if in_pack.device.type == "cpu":
        return gi_trace_ref(in_pack, looper, scene, **kw)
    if in_pack.device.type == "cuda":
        return gi_trace_cuda(in_pack, looper, scene, **kw)
    raise ValueError(f"unsupported device {in_pack.device}")


def gi_trace_ref(in_pack, looper, scene, *, depth, single_sided, n_lights,
                 pix0=0, has_met=True, has_die=True, has_proc=True):
    """Plain B8: `models.restir_gi`'s bounce loop on the IN pack, with
    the brute-force intersections of `ops.intersect_bf` on any device.
    The base colour of the primary vertex is 0, as the TPU kernel seeds
    it: the first bounce reads only the lobe's direction and pdf."""
    from ...models.restir_gi import _trace_paths
    from ..bsdf import SurfaceMaterial

    del has_met, has_die, has_proc  # every lobe is evaluated here
    r = in_pack.shape[1]
    if n_lights != scene.light_prob.shape[0]:
        raise ValueError(f"n_lights {n_lights} != the scene's "
                         f"{scene.light_prob.shape[0]} alias slots")
    mat = SurfaceMaterial(
        type=in_pack[IN_MTYPE].to(torch.int32),
        base_color=torch.zeros((r, 3), dtype=torch.float32,
                               device=in_pack.device),
        metallic=in_pack[IN_METAL], roughness=in_pack[IN_ROUGH],
        ior=in_pack[IN_IOR])
    lo, nv, xs, ns, pdf, delta = _trace_paths(
        scene, in_pack[IN_POS:IN_POS + 3].T, in_pack[IN_NORM:IN_NORM + 3].T,
        -in_pack[IN_DIR:IN_DIR + 3].T, mat, in_pack[IN_ALIVE] > 0.5,
        depth=depth, single_sided=single_sided, has_env=False,
        with_textures=False, looper=looper, pix0=pix0, plain=True)
    out = torch.zeros((GO_CH, r), dtype=torch.float32, device=in_pack.device)
    out[GO_LO:GO_LO + 3] = lo.T
    out[GO_NV:GO_NV + 3] = nv.T
    out[GO_XS:GO_XS + 3] = xs.T
    out[GO_NS:GO_NS + 3] = ns.T
    out[GO_PDF] = pdf
    out[GO_DELTA] = delta.to(torch.float32)
    return out


def gi_trace_cuda(in_pack, looper, scene, *, depth, single_sided, n_lights,
                  pix0=0, has_met=True, has_die=True, has_proc=True,
                  stats=False):
    """B8 on the card: the [GO_CH, R] trace pack; with `stats` also the
    [3, R] int32 box tests, plane tests and path vertices of each ray."""
    global trace_launches
    t, bvh = scene.tables, scene.bvh
    dev = in_pack.device
    r = in_pack.shape[1]
    _check(in_pack, "in_pack", IN_CH, r, dev)
    n_tris = scene.num_tris
    if not 0 < n_tris <= MAX_TRIS:
        raise ValueError(f"B8 is held to the JAX GI gate of at most "
                         f"{MAX_TRIS} triangles (ROADMAP A6c), the scene has "
                         f"{n_tris}")
    if not 0 < n_lights == t.gi_lights.shape[0]:
        raise ValueError(f"n_lights {n_lights}: the scene has "
                         f"{t.gi_lights.shape[0]} alias slots (B8 needs one)")
    if not 1 <= depth <= 64:
        raise ValueError(f"depth {depth} outside [1, 64]")
    smem = n_lights * 8 * 4  # the light rows
    if smem > SMEM_MAX:
        raise ValueError(f"B8 needs {smem} bytes of shared memory, over "
                         f"the {SMEM_MAX} a block can use")
    for name, tab in (("planes", bvh.planes), ("rows", bvh.rows),
                      ("gi_tri", t.gi_tri), ("mat", t.mat),
                      ("gi_lights", t.gi_lights)):
        if (tab.device != dev or tab.dtype != torch.float32
                or not tab.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if tuple(bvh.rows.shape) != (6 * bvh.size, 8):
        raise ValueError(f"rows: expected [{6 * bvh.size}, 8], got "
                         f"{tuple(bvh.rows.shape)}")
    in_pack = in_pack.contiguous()
    out = torch.empty((GO_CH, r), dtype=torch.float32, device=dev)
    counts = (torch.empty((3, r), dtype=torch.int32, device=dev)
              if stats else None)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_gi_trace(
            p(in_pack), r, ctypes.c_uint32(looper & 0xFFFFFFFF),
            ctypes.c_uint32(pix0 & 0xFFFFFFFF), p(bvh.rows), bvh.size,
            p(bvh.planes), p(t.gi_tri), p(t.mat), t.mat.shape[0],
            p(t.gi_lights), n_lights, ctypes.c_float(t.sum_light_power_inv),
            depth, int(single_sided), int(has_met), int(has_die),
            int(has_proc), p(out), p(counts), _build.stream_of(dev))
    _build.check(err, "restir_gi_trace")
    trace_launches += 1
    return (out, counts) if stats else out


# ---------------------------------------------------------------------------
# B9


def gi_resolve(go, in_pack, gq, q_prev, looper, *, temporal=True,
               temporal_clamp=20, has_met=True, window=WINDOW, pix0=0,
               prev_base=0, r_prev=None):
    """(indirect [3, R], next resolve pack [Q_CH, R]) of one frame.
    `q_prev` holds the previous pack's global pixels from `prev_base` of
    a frame of `r_prev` pixels (default: all of it, from 0)."""
    kw = dict(temporal=temporal, temporal_clamp=temporal_clamp,
              has_met=has_met, window=window, pix0=pix0,
              prev_base=prev_base, r_prev=r_prev)
    if go.device.type == "cpu":
        return gi_resolve_ref(go, in_pack, gq, q_prev, looper, **kw)
    if go.device.type == "cuda":
        return gi_resolve_cuda(go, in_pack, gq, q_prev, looper, **kw)
    raise ValueError(f"unsupported device {go.device}")


def _bad(x):
    return torch.isnan(x) | torch.isinf(x)


def window_starts(gq, r_prev: int, window: int = WINDOW):
    """Per-tile start of the temporal window [R / TILE] (int64): the
    least motion index over the tile's pixels with motion >= 0 and a
    primitive (else r_prev), floored to 128 and clipped to
    [0, r_prev - window] (gi_kernel.py:1118-1129)."""
    m = gq[GQ_MOTION]
    valid = (m >= 0.0) & (gq[GQ_PRIM] > NULL_PRIM)
    m_valid = torch.where(valid, m, float(r_prev))
    w0 = m_valid.reshape(-1, TILE).amin(dim=1).to(torch.int32).to(
        torch.int64)
    w0 = torch.div(w0, 128, rounding_mode="floor") * 128
    return torch.clamp(w0, 0, max(r_prev - window, 0))


def _prev_range(q_prev, pix0, prev_base, r_prev):
    """The global pixel count of the previous frame, checked against the
    held range of `q_prev`."""
    n_prev = q_prev.shape[1]
    if r_prev is None:
        r_prev = prev_base + n_prev
    if pix0 < 0 or prev_base < 0 or n_prev <= 0 or (
            prev_base + n_prev > r_prev):
        raise ValueError(f"B9 band arguments: pix0 {pix0}, previous pixels "
                         f"[{prev_base}, {prev_base + n_prev}) of {r_prev}")
    return r_prev


def gi_resolve_ref(go, in_pack, gq, q_prev, looper, *, temporal=True,
                   temporal_clamp=20, has_met=True, window=WINDOW, pix0=0,
                   prev_base=0, r_prev=None):
    """Plain B9, lane for lane as `_gi_resolve_kernel` computes it, with
    the kernel's band arguments."""
    from ...utils import rng

    r = go.shape[1]
    if r % TILE:
        raise ValueError(f"B9 works on whole {TILE}-pixel tiles, R={r}")
    r_prev = _prev_range(q_prev, pix0, prev_base, r_prev)
    dev = go.device
    pix = torch.arange(pix0, pix0 + r, device=dev)

    def g(i):
        return go[i]

    def inn(i):
        return in_pack[i]

    # trace output -> candidate sample (trace_gi_sample_fused's epilogue)
    lx, ly, lz = g(GO_LO), g(GO_LO + 1), g(GO_LO + 2)
    lo_bad = _bad(lx) | _bad(ly) | _bad(lz)
    lx = torch.where(lo_bad, 0.0, lx)
    ly = torch.where(lo_bad, 0.0, ly)
    lz = torch.where(lo_bad, 0.0, lz)
    xv = [inn(IN_POS + k) for k in range(3)]
    nv = [g(GO_NV + k) for k in range(3)]
    xs = [g(GO_XS + k) for k in range(3)]
    ns = [g(GO_NS + k) for k in range(3)]
    prim_pdf = g(GO_PDF)
    prim_delta = g(GO_DELTA) > 0.5

    lum = 0.2126 * lx + 0.7152 * ly + 0.0722 * lz
    dx = [xs[k] - xv[k] for k in range(3)]
    seg2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    valid = (lum >= 1e-8) & (seg2 > 0.0)

    # RIS weight and the update of an empty reservoir (M 0 -> 1)
    w = lum / torch.clamp(prim_pdf, min=1e-20)
    w = torch.where(_bad(w) | (w < 0.0) | ~valid, 0.0, w)
    r_upd = rng.uniform1(pix, looper, CTR_UPDATE, SALT_GI)
    take0 = r_upd * w < w
    s = [torch.where(take0, v, 0.0) for v in (lx, ly, lz, *xv, *nv, *xs,
                                                *ns)]
    r_w = w
    r_m = torch.ones_like(w)

    prim = gq[GQ_PRIM]
    gn = [gq[GQ_NORM + k] for k in range(3)]
    depth = gq[GQ_DEPTH]

    if temporal:
        w0 = window_starts(gq, r_prev, window).repeat_interleave(TILE)
        motion = gq[GQ_MOTION].to(torch.int32).to(torch.int64)
        rel = motion - w0
        in_win = (motion >= 0) & (rel >= 0) & (rel < window)
        at = w0 + torch.where(in_win, rel, 0) - prev_base
        held = (at >= 0) & (at < q_prev.shape[1])
        gathered = q_prev[:, torch.where(held, at, 0)]
        n_w = gathered[Q_W]
        n_m = gathered[Q_M]
        ok = in_win & held & (prim > NULL_PRIM)
        ok = ok & (gathered[Q_PRIM] == prim)
        ok = ok & (torch.abs(gn[0] * gathered[Q_GNORM]
                             + gn[1] * gathered[Q_GNORM + 1]
                             + gn[2] * gathered[Q_GNORM + 2]) >= 0.9)
        ok = ok & (torch.abs(gathered[Q_DEPTH] - depth) <= depth * 0.1)
        ok = ok & ~(_bad(n_w) | (n_w < 0.0))
        r_t = rng.uniform1(pix, looper, CTR_TEMPORAL, SALT_GI)
        w_new = torch.where(ok, r_w + n_w, r_w)
        m_new = torch.where(ok, r_m + n_m, r_m)
        take = ok & (r_t * w_new < n_w)
        s = [torch.where(take, gathered[Q_LO + i], v)
             for i, v in enumerate(s)]
        r_w, r_m = w_new, m_new

    # M cap (restir.h:88-93)
    cap = float(temporal_clamp)
    over = r_m > cap
    scale = cap / torch.clamp(r_m, min=1.0)
    r_w = torch.where(over, r_w * scale, r_w)
    r_m = torch.where(over, cap, r_m)

    # shade at the visible point, demodulated (restir.cu:399-408)
    s_lo, s_xv, s_nv, s_xs = s[0:3], s[3:6], s[6:9], s[9:12]
    wi = [s_xs[k] - s_xv[k] for k in range(3)]
    inv_l = 1.0 / torch.clamp(torch.sqrt(
        wi[0] * wi[0] + wi[1] * wi[1] + wi[2] * wi[2]), min=1e-20)
    wi = [v * inv_l for v in wi]
    wo = [-inn(IN_DIR + k) for k in range(3)]
    scalar = 0.2126 * s_lo[0] + 0.7152 * s_lo[1] + 0.0722 * s_lo[2]
    w_big = r_w / torch.clamp(r_m, min=1.0)
    inv_sc = 1.0 / torch.clamp(scalar, min=1e-20)
    f = eval_bsdf_lum(inn(IN_MTYPE), inn(IN_METAL), inn(IN_ROUGH),
                      tuple(s_nv), tuple(wo), tuple(wi), has_met=has_met)
    cosw = torch.where(prim_delta, 1.0, torch.clamp(
        s_nv[0] * wi[0] + s_nv[1] * wi[1] + s_nv[2] * wi[2], min=0.0))
    fc = f * cosw
    ind = [v * inv_sc * w_big * fc for v in s_lo]
    res_bad = _bad(r_w) | (r_w < 0.0)
    mask = (gq[GQ_SHADE] > 0.5) & ~res_bad & (scalar > 0.0)
    ind = [torch.where(mask, v, 0.0) for v in ind]
    ind_bad = _bad(ind[0]) | _bad(ind[1]) | _bad(ind[2])
    ind = torch.stack([torch.where(ind_bad, 0.0, v) * gq[GQ_ALB + k]
                       for k, v in enumerate(ind)])

    # check_validity (restir.h:55-59)
    r_w = torch.where(res_bad, 0.0, r_w)
    r_m = torch.where(res_bad, 0.0, r_m)
    q = torch.zeros((Q_CH, r), dtype=torch.float32, device=dev)
    q[Q_LO:Q_NS + 3] = torch.stack(s)
    q[Q_W] = r_w
    q[Q_M] = r_m
    q[Q_PRIM] = prim
    q[Q_GNORM:Q_GNORM + 3] = torch.stack(gn)
    q[Q_DEPTH] = depth
    return ind, q


def gi_resolve_cuda(go, in_pack, gq, q_prev, looper, *, temporal=True,
                    temporal_clamp=20, has_met=True, window=WINDOW, pix0=0,
                    prev_base=0, r_prev=None):
    """B9 on the card: (indirect [3, R], next resolve pack [Q_CH, R]),
    with the band arguments of `gi_resolve`."""
    global resolve_launches
    dev = go.device
    r = go.shape[1]
    if r % TILE:
        raise ValueError(f"B9 works on whole {TILE}-pixel tiles, R={r}")
    if window != WINDOW:
        raise ValueError(f"B9 is built for a {WINDOW}-pixel window")
    _check(go, "go", GO_CH, r, dev)
    _check(in_pack, "in_pack", IN_CH, r, dev)
    _check(gq, "gq", GQ_CH, r, dev)
    if (q_prev.device != dev or q_prev.dtype != torch.float32
            or q_prev.dim() != 2 or q_prev.shape[0] != Q_CH):
        raise ValueError(f"q_prev: expected float32 [{Q_CH}, *] on {dev}")
    r_prev = _prev_range(q_prev, pix0, prev_base, r_prev)
    go, in_pack, gq = go.contiguous(), in_pack.contiguous(), gq.contiguous()
    q_prev = q_prev.contiguous()
    ind = torch.empty((3, r), dtype=torch.float32, device=dev)
    q = torch.empty((Q_CH, r), dtype=torch.float32, device=dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_gi_resolve(
            p(go), p(in_pack), p(gq), p(q_prev), r_prev, q_prev.shape[1],
            prev_base, r, ctypes.c_uint32(looper & 0xFFFFFFFF),
            ctypes.c_uint32(pix0), int(temporal), int(temporal_clamp),
            int(has_met), p(ind), p(q), _build.stream_of(dev))
    _build.check(err, "restir_gi_resolve")
    resolve_launches += 1
    return ind, q
