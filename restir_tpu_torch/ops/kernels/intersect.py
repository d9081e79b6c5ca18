"""Kernels B11 (closest hit, and its any-hit variant) and B12 (primary
hit), with their plain PyTorch versions.

Ports of `restir_tpu.ops.pallas.intersect_kernel`:
- B11 `_closest_kernel` (`intersect_closest_pallas`): the closest hit of
  each ray over the scene's triangles -> dist (inf on a miss),
  barycentrics (0 on a miss) and triangle id (-1 on a miss), ties to the
  lowest triangle id. Its any-hit variant is `test_occlusion_pallas`'s
  contract: the segment x -> y, origin x + d 1e-5, occluded iff a hit
  lies nearer than |y - x| - 2e-4.
- B12 `_primary_kernel` (`primary_hit_pallas`): B11's closest hit, then
  the winner's attribute row interpolated (position, normalised normal,
  uv) and its material row, as a [24, R] pack in the TPU kernel's
  channel order. A miss interpolates a zero row and so reads material
  row 0, as the TPU kernel does.

CUDA tensors launch `csrc/intersect.cu`, whose threads walk the scene's
MTBVH (`trv.rows`, `trv.size`) and run the plain version's plane test on
the leaves they reach; the walk returns the plain version's hit, so the
kernels equal their twins bit for bit on the card. CPU tensors take the
plain versions, which test every triangle: `intersect_bf` (float32
products, the JAX package's CPU route) and, for B12, the interpolation
on top of it. Nothing falls back. The any hit and B12 take a mask of
live lanes (`active`); the kernels do not walk the others.
`trv` is an `ops.intersect.TraversalArrays`.
"""

from __future__ import annotations

import torch

from .. import intersect_bf
from . import _build

closest_launches = 0  # B11 closest-hit launches
any_launches = 0  # B11 any-hit launches
primary_launches = 0  # B12 launches

# B12 pack channels (intersect_kernel.py:101-106)
CH_DIST, CH_U, CH_V = 0, 1, 2
CH_POS, CH_NORM, CH_UV = 3, 6, 9
CH_MAT = 11  # 11..22: type, base colour (3), metallic, roughness, ior,
#              base / metallic / roughness / normal map ids, material id
CH_PRIM = 23
PRIMARY_CH = 24


def _rays(t: torch.Tensor, name: str, r: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (r, 3):
        raise ValueError(f"{name}: expected float32 [{r}, 3], got "
                         f"{t.dtype} {tuple(t.shape)}")


def _device_of(o) -> str:
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {o.device}")
    return o.device.type


def _launch_args(trv, *rays):
    """Checked, contiguous rays and the MTBVH tables the kernels walk."""
    r = rays[0].shape[0]
    for i, t in enumerate(rays):
        _rays(t, f"ray array {i}", r)
    dev = rays[0].device
    for name, tab in (("planes", trv.planes), ("rows", trv.rows)):
        if (tab.device != dev or tab.dtype != torch.float32
                or not tab.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on the "
                             "rays' device")
    if tuple(trv.rows.shape) != (6 * trv.size, 8):
        raise ValueError(f"rows: expected [{6 * trv.size}, 8], got "
                         f"{tuple(trv.rows.shape)}")
    n = trv.tri_xform.shape[1] // 3  # the rows past n are zero padding
    if not 0 < n <= trv.planes.shape[0]:
        raise ValueError(f"{n} triangles for {trv.planes.shape[0]} plane "
                         "rows")
    return [t.contiguous() for t in rays], n, r


def _active(active, r):
    if active is None:
        return None
    if tuple(active.shape) != (r,) or active.dtype != torch.bool:
        raise ValueError("active must be bool [R]")
    return active.contiguous()


def _tables(trv):
    return _build.ptr(trv.rows), trv.size, _build.ptr(trv.planes)


def _counts(stats, r, dev):
    return torch.empty((2, r), dtype=torch.int32, device=dev) if stats \
        else None


def closest_cuda(trv, o, d, stats=False):
    """B11 on the card -> (prim [R] i32, dist [R], bary [R, 2]); with
    `stats` also the int32 [2, R] box and plane tests of each ray."""
    global closest_launches
    (o, d), _, r = _launch_args(trv, o, d)
    dev = o.device
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    dist = torch.empty((r,), dtype=torch.float32, device=dev)
    bary = torch.empty((r, 2), dtype=torch.float32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    err = _build.library().restir_closest_hit(
        p(o), p(d), *_tables(trv), p(dist), p(bary), p(prim), p(counts), r,
        _build.stream_of(dev))
    _build.check(err, "restir_closest_hit")
    closest_launches += 1
    out = (prim, dist, bary)
    return (*out, counts) if stats else out


def closest_hit(trv, o, d, active=None):
    """Closest hit (prim, dist, bary); inactive lanes get prim -1 and
    dist inf after the test, as `intersect_closest_pallas`."""
    if _device_of(o) == "cpu":
        return intersect_bf.intersect_closest_bf(trv.tri_xform, o, d, active)
    prim, dist, bary = closest_cuda(trv, o, d)
    if active is not None:
        dist = torch.where(active, dist, torch.inf)
        prim = torch.where(active, prim, -1)
    return prim, dist, bary


def any_cuda(trv, x, y, active=None, stats=False):
    """B11's any-hit variant on the card -> occluded bool [R]; lanes with
    active False are not walked and read False. With `stats` also the
    int32 [2, R] box and plane tests of each segment."""
    global any_launches
    (x, y), _, r = _launch_args(trv, x, y)
    dev = x.device
    active = _active(active, r)
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    err = _build.library().restir_any_hit(
        p(x), p(y), p(active), *_tables(trv), p(occ), p(counts), r,
        _build.stream_of(dev))
    _build.check(err, "restir_any_hit")
    any_launches += 1
    return (occ, counts) if stats else occ


def any_hit(trv, x, y, active=None):
    """Any hit between x and y (bool [R])."""
    if _device_of(x) == "cpu":
        return intersect_bf.test_occlusion_bf(trv.tri_xform, x, y, active)
    return any_cuda(trv, x, y, active)


def primary_ref(trv, prim_attr, mat_attr, o, d, active=None):
    """Plain B12: the [24, R] pack from intersect_bf's closest hit;
    inactive lanes get the miss pack."""
    prim, dist, bary = intersect_bf.intersect_closest_bf(trv.tri_xform, o, d,
                                                         active)
    hit = prim >= 0
    u = torch.where(hit, bary[:, 0], 0.0)[:, None]
    v = torch.where(hit, bary[:, 1], 0.0)[:, None]
    a = torch.where(hit[:, None], prim_attr[prim.clamp(min=0).long()], 0.0)
    pos = a[:, 0:3] + u * a[:, 3:6] + v * a[:, 6:9]
    nrm = a[:, 9:12] + u * a[:, 12:15] + v * a[:, 15:18]
    nlen = torch.sqrt(torch.clamp(
        nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1] + nrm[:, 2] * nrm[:, 2],
        min=1e-20))
    nrm = nrm / nlen[:, None]
    uv = a[:, 18:20] + u * a[:, 20:22] + v * a[:, 22:24]
    mat_id = a[:, 24].to(torch.int64)
    ok = (mat_id >= 0) & (mat_id < mat_attr.shape[0])
    m = torch.where(ok[:, None],
                    mat_attr[mat_id.clamp(0, mat_attr.shape[0] - 1)], 0.0)
    return torch.cat([
        dist[None], u.T, v.T, pos.T, nrm.T, uv.T, m[:, 0:11].T,
        a[:, 24][None], prim.to(torch.float32)[None]])


def primary_cuda(trv, prim_attr, mat_attr, o, d, active=None, stats=False):
    """B12 on the card -> the [24, R] pack; lanes with active False are
    not walked and get the miss pack. With `stats` also the int32 [2, R]
    box and plane tests of each ray."""
    global primary_launches
    (o, d), n, r = _launch_args(trv, o, d)
    dev = o.device
    active = _active(active, r)
    for name, t, cols in (("prim_attr", prim_attr, 32),
                          ("mat_attr", mat_attr, 16)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[1] != cols):
            raise ValueError(f"{name}: expected float32 [*, {cols}] on {dev}")
    if prim_attr.shape[0] != n:
        raise ValueError(f"prim_attr holds {prim_attr.shape[0]} rows for "
                         f"{n} triangles")
    attr, mat = prim_attr.contiguous(), mat_attr.contiguous()
    out = torch.empty((PRIMARY_CH, r), dtype=torch.float32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    err = _build.library().restir_primary_hit(
        p(o), p(d), p(active), *_tables(trv), p(attr), p(mat), mat.shape[0],
        p(out), p(counts), r, _build.stream_of(dev))
    _build.check(err, "restir_primary_hit")
    primary_launches += 1
    return (out, counts) if stats else out


def primary_hit(trv, prim_attr, mat_attr, o, d, active=None):
    """(prim [R] i32, dist [R], bary [R, 2], pos [R, 3], norm [R, 3],
    uv [R, 2], mat_params [R, 12]) as `primary_hit_pallas` returns them,
    with the miss pack on lanes where `active` is False; mat_params
    columns: type, base colour (3), metallic, roughness, ior, the four
    map ids, material id."""
    if _device_of(o) == "cpu":
        out = primary_ref(trv, prim_attr, mat_attr, o, d, active)
    else:
        out = primary_cuda(trv, prim_attr, mat_attr, o, d, active)
    return unpack_primary(out)


def unpack_primary(out):
    return (out[CH_PRIM].to(torch.int32), out[CH_DIST],
            out[CH_U:CH_V + 1].T, out[CH_POS:CH_POS + 3].T,
            out[CH_NORM:CH_NORM + 3].T, out[CH_UV:CH_UV + 2].T,
            out[CH_MAT:CH_PRIM].T)
