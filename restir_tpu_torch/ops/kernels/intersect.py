"""Kernels B11 (closest hit, and its any-hit variant), B12 (primary
hit), B13 (the exact MTBVH walk: closest, any and primary hit) and B14
(the BVH heatmap), with their plain PyTorch versions.

Ports of `restir_tpu.ops.pallas.intersect_kernel` (the brute-force
method, `trv.method == "brute"`):
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
on top of it.

Every other method is the JAX package's lockstep MTBVH walk with the
Möller-Trumbore leaf test (`restir_tpu.ops.intersect`, XLA loops there,
not Pallas kernels): B13 `mt_closest_cuda` / `mt_any_cuda` /
`mt_primary_cuda` (`intersect_closest_bvh`, `test_occlusion_bvh`, and
B12's pack on the walk's hit) and B14 `heatmap_cuda`
(`intersect_visualize`, on any method). They walk `trv.walk`'s exact
node rows and vertex rows (`tables.WalkTables`) in `csrc/intersect.cu`,
with the twins' arithmetic under -fmad=false, so they equal the twins in
`ops.intersect` bit for bit on the card; CPU tensors take those twins.

Nothing falls back. The any hits and the primary hits take a mask of
live lanes (`active`); the kernels do not walk the others.
`trv` is an `ops.intersect.TraversalArrays`.

B13's primary and any hit and B14 take the batch's geometry `geom =
(width, pix0)` where the batch holds one ray per pixel of a band,
row-major from global pixel pix0 of a frame `width` pixels wide (a
whole frame: pix0 = 0), as every render path's camera rays, bounce
rays and NEE segments are, and the heatmap's pixel-centre rays. They
then launch on 8x4-pixel warps, whose rays leave one small
patch of the image and walk nearly the same nodes. A batch without
geometry launches in ray order. B13's closest hit, the ray-query entry
point `closest_hit`'s, keys its rays by the loop their walk runs, sorts
them (`ray_order`, `csrc/sort.cu`) and walks them in that order through
the permutation. The launch and the order change which thread walks
which ray, never how a ray is walked: every order writes the same bits.
The plain versions ignore the geometry; a geometry that cannot hold the
batch raises `ValueError` on any device.
"""

from __future__ import annotations

import torch

from .. import intersect_bf
from . import _build, ray_order

closest_launches = 0  # B11 closest-hit launches
any_launches = 0  # B11 any-hit launches
primary_launches = 0  # B12 launches
mt_closest_launches = 0  # B13 closest-hit launches
mt_any_launches = 0  # B13 any-hit launches
mt_primary_launches = 0  # B13 primary-hit launches
heatmap_launches = 0  # B14 launches

# B13's closest hit (the ray query) walks a batch of fewer rays in ray
# order, unsorted: on an H100 the sort's five launches outweigh what it
# gains up to 128 of the hall's bounce rays (device ms 0.127 against
# 0.158 sorted at 128 rays, 0.289 against 0.216 at 256; PERF.md)
QUERY_SORT_MIN = 256
# ... and a batch of more rays than one sort takes in ray order too, as
# the walk alone serves any R below 2^31
QUERY_SORT_MAX = ray_order.SORT_MAX_KEYS

_INT_MAX = 2**31 - 1
_TILE_ROWS_MAX = 65535 * 8  # tile rows of one launch (gridDim.y * 8)

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


def _checked(rays, rows, size, leaves, n):
    """Checked, contiguous rays and a walk's tables: node rows [6B, 8] and
    leaf rows [n_pad, 12] for n triangles (the rows past n are zero
    padding)."""
    r = rays[0].shape[0]
    for i, t in enumerate(rays):
        _rays(t, f"ray array {i}", r)
    dev = rays[0].device
    for name, tab in (("node rows", rows), ("leaf rows", leaves)):
        if (tab.device != dev or tab.dtype != torch.float32
                or not tab.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 on the "
                             "rays' device")
    if tuple(rows.shape) != (6 * size, 8):
        raise ValueError(f"node rows: expected [{6 * size}, 8], got "
                         f"{tuple(rows.shape)}")
    if leaves.dim() != 2 or leaves.shape[1] != 12 or not (
            0 < n <= leaves.shape[0]):
        raise ValueError(f"{n} triangles for leaf rows "
                         f"{tuple(leaves.shape)}")
    return [t.contiguous() for t in rays], n, r


def _launch_args(trv, *rays):
    """B11 / B12's arguments: the padded node rows and the plane rows."""
    return _checked(rays, trv.rows, trv.size, trv.planes,
                    trv.tri_xform.shape[1] // 3)


def _walk_args(trv, *rays):
    """B13 / B14's arguments: the exact node rows and the vertex rows."""
    w = trv.walk
    if w is None:
        raise ValueError("the MTBVH walk's tables are missing: build the "
                         "TraversalArrays with a walk method or walk=True")
    return _checked(rays, w.rows, w.size, w.vert_rows, w.verts.shape[0])


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
    with _build.on_device(dev):
        err = _build.library().restir_closest_hit(
            p(o), p(d), *_tables(trv), p(dist), p(bary), p(prim), p(counts), r,
            _build.stream_of(dev))
    _build.check(err, "restir_closest_hit")
    closest_launches += 1
    out = (prim, dist, bary)
    return (*out, counts) if stats else out


def _walks(trv) -> bool:
    """Whether `trv`'s method is the MTBVH walk (B13) or brute force."""
    return trv.method != "brute"


def closest_plain(trv, o, d, active=None):
    """The plain closest hit of `trv`'s method (prim, dist, bary), on
    any device: `intersect_bf` or the walk's twin."""
    if _walks(trv):
        from .. import intersect as ix

        return ix.intersect_closest_bvh(trv.walk, o, d, active)
    return intersect_bf.intersect_closest_bf(trv.tri_xform, o, d, active)


def closest_hit(trv, o, d, active=None):
    """Closest hit (prim, dist, bary); inactive lanes get prim -1 and
    dist inf, as `intersect_closest_pallas` / `intersect_closest_bvh`."""
    if _device_of(o) == "cpu":
        return closest_plain(trv, o, d, active)
    if _walks(trv):
        return mt_closest_cuda(trv, o, d, active)
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
    with _build.on_device(dev):
        err = _build.library().restir_any_hit(
            p(x), p(y), p(active), *_tables(trv), p(occ), p(counts), r,
            _build.stream_of(dev))
    _build.check(err, "restir_any_hit")
    any_launches += 1
    return (occ, counts) if stats else occ


def any_hit(trv, x, y, active=None, geom=None):
    """Any hit between x and y (bool [R]); `geom` (width, pix0): the
    batch's pixels, for B13's launch."""
    if geom is not None:
        check_geometry(geom, x.shape[0])
    if _device_of(x) == "cpu":
        if _walks(trv):
            from .. import intersect as ix

            return ix.test_occlusion_bvh(trv.walk, x, y, active)
        return intersect_bf.test_occlusion_bf(trv.tri_xform, x, y, active)
    if _walks(trv):
        return mt_any_cuda(trv, x, y, active, geom=geom)
    return any_cuda(trv, x, y, active)


def primary_ref(trv, prim_attr, mat_attr, o, d, active=None):
    """Plain B12 / B13 primary hit: the [24, R] pack from the closest hit
    of `trv`'s method; inactive lanes get the miss pack."""
    prim, dist, bary = closest_plain(trv, o, d, active)
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
    attr, mat = _attr_tables(prim_attr, mat_attr, n, dev)
    out = torch.empty((PRIMARY_CH, r), dtype=torch.float32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_primary_hit(
            p(o), p(d), p(active), *_tables(trv), p(attr), p(mat),
            mat.shape[0], p(out), p(counts), r, _build.stream_of(dev))
    _build.check(err, "restir_primary_hit")
    primary_launches += 1
    return (out, counts) if stats else out


def check_geometry(geom, r):
    """(width, pix0) of a batch of r rays, one per pixel from global
    pixel pix0 of a frame `width` wide; ValueError if that band cannot
    be launched: a width under 1, a negative pix0, more tile rows than a
    launch holds, or pixel indices past int32."""
    width, pix0 = (int(v) for v in geom)
    if width < 1 or pix0 < 0:
        raise ValueError(f"geometry (width {width}, pix0 {pix0}) cannot "
                         f"hold {r} rays")
    y0 = pix0 // width
    rows = (pix0 + r - 1) // width - y0 + 1
    gy, gx = -(-rows // 8), -(-width // 32)
    if rows > _TILE_ROWS_MAX or (y0 + 8 * gy) * width + 32 * gx > _INT_MAX:
        raise ValueError(f"geometry (width {width}, pix0 {pix0}) cannot "
                         f"hold {r} rays: the band's tiles pass the "
                         "launch's limits")
    return width, pix0


def _b13_geometry(geom, r):
    """(width, pix0) of a B13 primary or any-hit launch or a B14 launch:
    the batch's checked geometry (8x4-pixel warps), or (0, 0) without one
    (ray order)."""
    return (0, 0) if geom is None else check_geometry(geom, r)


def _attr_tables(prim_attr, mat_attr, n, dev):
    for name, t, cols in (("prim_attr", prim_attr, 32),
                          ("mat_attr", mat_attr, 16)):
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[1] != cols):
            raise ValueError(f"{name}: expected float32 [*, {cols}] on {dev}")
    if prim_attr.shape[0] != n:
        raise ValueError(f"prim_attr holds {prim_attr.shape[0]} rows for "
                         f"{n} triangles")
    return prim_attr.contiguous(), mat_attr.contiguous()


def primary_hit(trv, prim_attr, mat_attr, o, d, active=None, geom=None):
    """(prim [R] i32, dist [R], bary [R, 2], pos [R, 3], norm [R, 3],
    uv [R, 2], mat_params [R, 12]) as `primary_hit_pallas` returns them,
    with the miss pack on lanes where `active` is False; mat_params
    columns: type, base colour (3), metallic, roughness, ior, the four
    map ids, material id. `geom` (width, pix0): the batch's pixels, for
    B13's launch."""
    if geom is not None:
        check_geometry(geom, o.shape[0])
    if _device_of(o) == "cpu":
        out = primary_ref(trv, prim_attr, mat_attr, o, d, active)
    elif _walks(trv):
        out = mt_primary_cuda(trv, prim_attr, mat_attr, o, d, active,
                              geom=geom)
    else:
        out = primary_cuda(trv, prim_attr, mat_attr, o, d, active)
    return unpack_primary(out)


def unpack_primary(out):
    return (out[CH_PRIM].to(torch.int32), out[CH_DIST],
            out[CH_U:CH_V + 1].T, out[CH_POS:CH_POS + 3].T,
            out[CH_NORM:CH_NORM + 3].T, out[CH_UV:CH_UV + 2].T,
            out[CH_MAT:CH_PRIM].T)


def _walk_tables(trv):
    w = trv.walk
    return _build.ptr(w.rows), w.size, _build.ptr(w.vert_rows)


def mt_closest_cuda(trv, o, d, active=None, stats=False):
    """B13's closest hit on the card -> (prim [R] i32, dist [R], bary
    [R, 2]); lanes with active False are not walked (prim -1, dist inf,
    bary 0). With `stats` also the int32 [2, R] box and triangle tests
    of each ray. The rays are keyed (`ray_order.ray_key`), sorted
    (`ray_order.radix_sort`) and walked in that order
    (`mt_closest_walk`); a batch of fewer than QUERY_SORT_MIN rays or
    more than QUERY_SORT_MAX walks in ray order."""
    (o, d), _, r = _walk_args(trv, o, d)
    active = _active(active, r)
    perm = None
    if QUERY_SORT_MIN <= r <= QUERY_SORT_MAX:
        key = ray_order.ray_key(o, d, active, trv.walk.rows)
        perm = ray_order.radix_sort(key, ray_order.RAY_SORT_PASSES)[1]
    return _closest_walk(trv, o, d, active, perm, stats)


def mt_closest_walk(trv, o, d, active=None, perm=None, stats=False):
    """B13's closest-hit walk alone: slot i walks ray perm[i] (int32 [R],
    a permutation; None: ray i) and writes its results at that ray's
    index, as `mt_closest_cuda` returns them."""
    (o, d), _, r = _walk_args(trv, o, d)
    active = _active(active, r)
    if perm is not None and (tuple(perm.shape) != (r,)
                             or perm.dtype != torch.int32
                             or perm.device != o.device):
        raise ValueError(f"perm: expected int32 [{r}] on {o.device}")
    return _closest_walk(trv, o, d, active, perm, stats)


def _closest_walk(trv, o, d, active, perm, stats):
    """`mt_closest_walk`'s launch on checked arguments."""
    global mt_closest_launches
    r, dev = o.shape[0], o.device
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    dist = torch.empty((r,), dtype=torch.float32, device=dev)
    bary = torch.empty((r, 2), dtype=torch.float32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_mt_closest_hit(
            p(o), p(d), p(active), p(perm), *_walk_tables(trv), p(dist),
            p(bary), p(prim), p(counts), r, _build.stream_of(dev))
    _build.check(err, "restir_mt_closest_hit")
    mt_closest_launches += 1
    out = (prim, dist, bary)
    return (*out, counts) if stats else out


def mt_any_cuda(trv, x, y, active=None, stats=False, geom=None):
    """B13's any hit on the card -> occluded bool [R]; lanes with active
    False are not walked and read False. With `stats` also the int32
    [2, R] box and triangle tests of each segment. With `geom` (width,
    pix0) the batch launches on 8x4-pixel warps, else in ray order."""
    global mt_any_launches
    (x, y), _, r = _walk_args(trv, x, y)
    dev = x.device
    active = _active(active, r)
    width, pix0 = _b13_geometry(geom, r)
    occ = torch.empty((r,), dtype=torch.bool, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_mt_any_hit(
            p(x), p(y), p(active), *_walk_tables(trv), p(occ), p(counts),
            width, pix0, r, _build.stream_of(dev))
    _build.check(err, "restir_mt_any_hit")
    mt_any_launches += 1
    return (occ, counts) if stats else occ


def mt_primary_cuda(trv, prim_attr, mat_attr, o, d, active=None,
                    stats=False, geom=None):
    """B13's primary hit on the card -> B12's [24, R] pack on the walk's
    hit; lanes with active False are not walked and get the miss pack.
    With `stats` also the int32 [2, R] box and triangle tests. With
    `geom` (width, pix0) the batch launches on 8x4-pixel warps, else in
    ray order."""
    global mt_primary_launches
    (o, d), n, r = _walk_args(trv, o, d)
    dev = o.device
    active = _active(active, r)
    width, pix0 = _b13_geometry(geom, r)
    attr, mat = _attr_tables(prim_attr, mat_attr, n, dev)
    out = torch.empty((PRIMARY_CH, r), dtype=torch.float32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_mt_primary_hit(
            p(o), p(d), p(active), *_walk_tables(trv), p(attr), p(mat),
            mat.shape[0], p(out), p(counts), width, pix0, r,
            _build.stream_of(dev))
    _build.check(err, "restir_mt_primary_hit")
    mt_primary_launches += 1
    return (out, counts) if stats else out


def heatmap_cuda(trv, o, d, stats=False, geom=None):
    """B14 on the card -> the int32 [R] count of descended nodes of each
    ray's closest-hit walk; with `stats` also the int32 [2, R] box and
    triangle tests. With `geom` (width, pix0) the batch launches on
    8x4-pixel warps, else in ray order."""
    global heatmap_launches
    (o, d), _, r = _walk_args(trv, o, d)
    dev = o.device
    width, pix0 = _b13_geometry(geom, r)
    count = torch.empty((r,), dtype=torch.int32, device=dev)
    counts = _counts(stats, r, dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = _build.library().restir_bvh_heatmap(
            p(o), p(d), *_walk_tables(trv), p(count), p(counts), width, pix0,
            r, _build.stream_of(dev))
    _build.check(err, "restir_bvh_heatmap")
    heatmap_launches += 1
    return (count, counts) if stats else count


def heatmap(trv, o, d, geom=None):
    """Descended nodes per ray (int32 [R]): B14 on CUDA tensors,
    `intersect_visualize` on CPU tensors. `geom` (width, pix0): the
    batch's pixels, for B14's launch."""
    if geom is not None:
        check_geometry(geom, o.shape[0])
    if _device_of(o) == "cpu":
        from .. import intersect as ix

        return ix.intersect_visualize(trv.walk, o, d)
    return heatmap_cuda(trv, o, d, geom=geom)
