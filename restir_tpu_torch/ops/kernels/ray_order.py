"""Ray order for the walks (`csrc/sort.cu`): the ray key of B13's closest
hit and the one-sweep radix sort, with their plain PyTorch versions.

- `ray_key` groups rays by the loop their walk runs (`csrc/bvh.cuh`,
  `octant_walk`): the high bits hold the ray's class, the MTBVH table of
  -d with the signs of the inverse direction on the two other axes (24
  classes; the table fixes the dominant axis's sign), or one class for
  the rays that take the `slab` loop (an infinite direction or origin
  component). Lanes not cast and rays with a NaN component get the dead
  key, the largest. The low bits order a class by the origin's Morton
  code in the scene's box (the walk's root row; 5 bits an axis), as the
  probes' coherence key builds one, then a direction cell (|d_b| / |d_a|
  of the two other axes, 2 bits each): 24 bits, which 3 sort passes
  order.
- `radix_sort`: the stable one-sweep LSD radix sort of int32 keys, a
  histogram launch, then one launch for each pass of `SORT_BITS`-bit
  digits (`SORT_PASSES` for any key, `RAY_SORT_PASSES` for keys below
  2^24). Its twin is torch.sort(stable=True). `sort_kernel_launches`
  reads the kernels the sorts have launched, as the C entry point counts
  them.

The stage probes (`restir_tpu_torch.prof`) sort with the same kernels.
Each wrapper takes the twin on CPU tensors and launches its kernel on
CUDA tensors (or raises); the kernels equal the twins bit for bit.
"""

from __future__ import annotations

import torch

from ...scene.bvh import get_mtbvh_id
from . import _build

DEAD_KEY = 0x7FFFFFFF  # the key of a lane not cast: sorts last
SORT_BITS = 8
SORT_PASSES = 4  # 4 passes of 8 bits reach bit 30, which DEAD_KEY sets
SLAB_CLASS = 24  # the rays whose walk runs the `slab` loop
# the ray key: bits of each direction cell, Morton bits an axis, its
# width, its dead key (the largest) and the passes that sort it
RAY_DIR_BITS, RAY_MORTON_BITS = 2, 5
RAY_KEY_BITS = 5 + 2 * RAY_DIR_BITS + 3 * RAY_MORTON_BITS  # 24
RAY_DEAD_KEY = (1 << RAY_KEY_BITS) - 1
RAY_SORT_PASSES = 3
# the most keys one sort takes: a look-back word holds a tile's count in
# its low 30 bits (`csrc/sort.cu` kCountMask)
SORT_MAX_KEYS = (1 << 30) - 1

key_launches = 0  # ray-key launches
sort_launches = 0  # sorts on the card (1 + passes kernels each)


def _cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def _need(t, what, dtype, shape=None):
    """Raise unless t is a contiguous `dtype` tensor (of `shape`, if
    given)."""
    if t.dtype != dtype or not t.is_contiguous() or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{what}: need a contiguous {dtype} tensor of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)}")


def cell(p, lo, ext, bits):
    """floor(((p - lo) / ext) clamped to [0, 1 - 2^-24) x 2^bits), int64;
    NaN to cell 0."""
    u = (p - lo) / ext
    u = torch.where(u >= 0.0, u, torch.zeros_like(u))
    u = torch.clamp(u, max=0.99999994)
    return (u * float(1 << bits)).to(torch.int64)


def morton(p, lo, ext, bits):
    """Morton code of points p [R, 3] (bit b of axis a's cell at bit
    3b + a), int64."""
    q = [cell(p[:, a], lo[a], ext[a], bits) for a in range(3)]
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for b in range(bits):
        for a in range(3):
            code |= ((q[a] >> b) & 1) << (3 * b + a)
    return code


def ray_key_ref(o, d, active, rows):
    """The int32 [R] ray key of rays o -> d ([R, 3] float32), active None
    or bool [R], in the box of the walk's root row rows[0] (lo: 0:3, hi:
    4:7): class * 2^19 + Morton code * 2^4 + direction cells. The class
    is table * 4 + (the lower other axis negative) + 2 (the higher other
    axis negative), or SLAB_CLASS."""
    db, mb = RAY_DIR_BITS, RAY_MORTON_BITS
    table = get_mtbvh_id(-d[:, 0], -d[:, 1], -d[:, 2]).to(torch.int64)
    axis = (table >> 1)[:, None]
    lower = torch.where(axis == 0, 1, 0)
    higher = torch.where(axis == 2, 1, 2)
    neg = (d < 0.0).to(torch.int64)  # safe_inv's sign: -0.0 is positive
    cls = (table * 4 + neg.gather(1, lower)[:, 0]
           + 2 * neg.gather(1, higher)[:, 0])
    slab = torch.isinf(d).any(1) | torch.isinf(o).any(1)
    cls = torch.where(slab, SLAB_CLASS, cls)
    ad = d.abs()
    m = ad.gather(1, axis)[:, 0]
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    direction = ((cell(ad.gather(1, lower)[:, 0], zero, m, db) << db)
                 | cell(ad.gather(1, higher)[:, 0], zero, m, db))
    lo = [rows[0, a] for a in range(3)]
    ext = [rows[0, 4 + a] - rows[0, a] for a in range(3)]
    key = ((cls << (RAY_KEY_BITS - 5)) | (morton(o, lo, ext, mb) << (2 * db))
           | direction)
    dead = torch.isnan(o).any(1) | torch.isnan(d).any(1)
    if active is not None:
        dead |= ~active
    return torch.where(dead, RAY_DEAD_KEY, key).to(torch.int32)


def ray_key(o, d, active, rows):
    """`ray_key_ref` on CPU tensors, `csrc/sort.cu`'s ray key on CUDA."""
    global key_launches
    if not _cuda(o, "ray_key"):
        return ray_key_ref(o, d, active, rows)
    r = o.shape[0]
    _need(o, "o", torch.float32, (r, 3))
    _need(d, "d", torch.float32, (r, 3))
    if active is not None:
        _need(active, "active", torch.bool, (r,))
    _need(rows, "rows", torch.float32, (rows.shape[0], 8))
    key = torch.empty(r, dtype=torch.int32, device=o.device)
    p = _build.ptr
    with _build.on_device(o.device):
        err = _build.library().restir_ray_key(
            p(o), p(d), p(active), p(rows), r, p(key),
            _build.stream_of(o.device))
    _build.check(err, "restir_ray_key")
    key_launches += 1
    return key


def radix_sort_ref(keys):
    """(sorted keys, int32 permutation): torch.sort(stable=True)."""
    s = torch.sort(keys, stable=True)
    return s.values, s.indices.to(torch.int32)


def radix_sort(keys, passes=SORT_PASSES):
    """The one-sweep LSD radix sort of int32 keys [R] (0 < R <=
    SORT_MAX_KEYS, stable): `radix_sort_ref` on CPU tensors, the kernels
    on CUDA (1 + passes launches; 3 passes sort keys in [0, 2^24)
    only)."""
    global sort_launches
    if passes not in (RAY_SORT_PASSES, SORT_PASSES):
        raise ValueError(f"radix_sort: {passes} passes, not "
                         f"{RAY_SORT_PASSES} or {SORT_PASSES}")
    if not _cuda(keys, "radix_sort"):
        return radix_sort_ref(keys)
    r = keys.shape[0]
    _need(keys, "keys", torch.int32, (r,))
    dev = keys.device
    lib = _build.library()
    words = lib.restir_prof_sort_scratch(r)
    if words < 0:
        raise ValueError(f"radix_sort: {r} keys outside [1, {SORT_MAX_KEYS}]")
    ka, kb = (torch.empty(r, dtype=torch.int32, device=dev) for _ in "ab")
    va, vb = (torch.empty(r, dtype=torch.int32, device=dev) for _ in "ab")
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    p = _build.ptr
    with _build.on_device(dev):
        err = lib.restir_prof_radix_sort(p(keys), p(ka), p(va), p(kb), p(vb),
                                         p(scratch), r, passes,
                                         _build.stream_of(dev))
    _build.check(err, "restir_prof_radix_sort")
    sort_launches += 1
    return ka, va


def sort_kernel_launches() -> int:
    """Kernels every `radix_sort` on the card has launched so far in this
    process (the histogram and each pass, counted by `csrc/sort.cu` where
    the runtime took the launch); 1 + passes a sort."""
    return _build.library().restir_prof_sort_launches()
