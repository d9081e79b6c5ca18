"""Wrappers and plain twins of the probe kernels in `csrc/prof/`.

- `coherence_key`, `radix_sort`, `gather_cols`, `gather_rays`,
  `scatter_cols`, `copy_pack` (`csrc/sort.cu`, in the main library,
  whose sort B13's closest hit runs too: `ops.kernels.ray_order`): the
  ray order of prof_take / prof_wavefront; twins: the same float32 ops
  in torch, `torch.sort(stable=True)`, index_select, an indexed store,
  `clone`. The kernels equal them bit for bit. The sort is one-sweep: a
  histogram launch, then one launch for each of `SORT_PASSES` passes of
  `SORT_BITS`-bit digits.
- `anyhit` (`csrc/prof/anyhit.cu`, form "fma", "mma3" or "mma6"):
  prof_fma's brute-force any hit over padded plane rows; twins
  `anyhit_ref` (float32 dots, intersect_bf's test) and, for the tensor-
  core forms, the same dots on operands split into TF32 pieces (3xTF32:
  hi, mid; 6xTF32: hi, mid, lo). Held under the reference's primitive
  gate, which 3xTF32 misses on shadow segments. The tensor-core kernels
  take t from a reciprocal where the twins divide (a ray on an edge may
  differ); the FP32 kernel divides, two rays a lane on a persistent grid
  fed by a queue of ray groups.
- `table_gather` ("shared", "ldg", "tex") and `chain` ("soa", "aos",
  "float4") (`csrc/prof/mem.cu`): prof_gather's and prof_v3's memory
  paths; twins `index_select` and the loop in torch, bit for bit.
- `mark`: an empty kernel that delimits timed calls in a trace
  (`_timing`).

Each wrapper takes the twin on CPU tensors and launches its kernel on
CUDA tensors (or raises); nothing falls back. `launches` counts kernel
launches by name (a sort's 1 + passes launches count once);
`sort_kernel_launches` reads the kernels the sorts have launched, as the
C entry point counts them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.kernels import _build, ray_order
from ..ops.kernels.ray_order import (  # noqa: F401  (the probes' names)
    DEAD_KEY,
    SORT_BITS,
    SORT_PASSES,
    _cuda,
    _need,
    cell as _cell,
    morton as _morton,
    radix_sort_ref,
    sort_kernel_launches,
)

KEY_ORDERS = ("origin", "target_origin", "direction_origin")
CHAIN_ROUNDS = 90
CHAIN_FACTORS = np.array([0.5 + i * 1e-3 for i in range(CHAIN_ROUNDS)],
                         dtype=np.float32)
GATHER_WHERE = ("shared", "ldg", "tex")
CHAIN_LAYOUTS = ("soa", "aos", "float4")

# kernel launches by kernel (and variant); a wrapper adds one where it
# launches its kernel, nowhere else
launches = dict.fromkeys(
    ["key", "radix_sort", "gather", "scatter", "copy", "anyhit_fma",
     "anyhit_mma3", "anyhit_mma6"]
    + [f"table_gather_{w}" for w in GATHER_WHERE]
    + [f"chain_{c}" for c in CHAIN_LAYOUTS], 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    return _build.variant_library("prof")


# ---- ray order ---------------------------------------------------------------

def _direction(s):
    m = torch.clamp(s.abs().amax(dim=1), min=1e-30)
    code = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    for a in range(3):
        u = (s[:, a] / m + 1.0) * 0.5
        u = torch.where(u >= 0.0, u, torch.zeros_like(u))
        u = torch.clamp(u, max=0.99999994)
        code = (code << 4) | (u * 16.0).to(torch.int64)
    return code


def coherence_key_ref(x, y, live, lo, hi, order):
    """The int32 [R] coherence key of segments x -> y ([R, 3] float32) in
    the box lo..hi (3 floats each): "origin" (Morton, 10 bits an axis),
    "target_origin" (target cell, 3 bits, then origin, 7), or
    "direction_origin" (direction over its largest component, 4 bits,
    then origin, 6); 30 bits; DEAD_KEY where live is False."""
    dev = x.device
    lo32 = [torch.tensor(v, dtype=torch.float32, device=dev) for v in lo]
    ext = [torch.tensor(h, dtype=torch.float32, device=dev) - l
           for h, l in zip(hi, lo32)]
    if order == "origin":
        k = _morton(x, lo32, ext, 10)
    elif order == "target_origin":
        k = (_morton(y, lo32, ext, 3) << 21) | _morton(x, lo32, ext, 7)
    elif order == "direction_origin":
        k = (_direction(y - x) << 18) | _morton(x, lo32, ext, 6)
    else:
        raise ValueError(f"unknown key order {order!r}")
    return torch.where(live, k, DEAD_KEY).to(torch.int32)


def coherence_key(x, y, live, lo, hi, order):
    """`coherence_key_ref` on CPU tensors, `csrc/sort.cu` on CUDA."""
    if not _cuda(x, "coherence_key"):
        return coherence_key_ref(x, y, live, lo, hi, order)
    r = x.shape[0]
    _need(x, "x", torch.float32, (r, 3))
    _need(y, "y", torch.float32, (r, 3))
    _need(live, "live", torch.bool, (r,))
    key = torch.empty(r, dtype=torch.int32, device=x.device)
    p = _build.ptr
    with _build.on_device(x.device):
        err = _build.library().restir_prof_key(
            p(x), p(y), p(live), r, *(ctypes.c_float(float(v))
                                      for v in (*lo, *hi)),
            KEY_ORDERS.index(order), p(key), _build.stream_of(x.device))
    _build.check(err, "restir_prof_key")
    launches["key"] += 1
    return key


def radix_sort(keys):
    """`ray_order.radix_sort` (SORT_PASSES passes), counted as a probe
    sort in `launches`."""
    out = ray_order.radix_sort(keys)
    if keys.device.type == "cuda":
        launches["radix_sort"] += 1
    return out


def _permute(channels, perm, scatter, group=1):
    """Launch `csrc/sort.cu`'s permute kernel on channels [(source,
    its step, output, its step)], each a CUDA tensor of 4-byte or 1-byte
    elements viewed from its first element, `group` channels a block.
    Blocks run group by group, so the rows read (or written) at permuted
    columns while a group moves stay in L2: one row of a [C, R] pack (all
    nine of the hall's 1080p pack at once overflow it), B13's [R, 3]
    inputs an array at a time (group 3)."""
    r = perm.shape[0]
    n = len(channels)
    src = (ctypes.c_longlong * n)(*(s.data_ptr() for s, _, _, _ in channels))
    dst = (ctypes.c_longlong * n)(*(d.data_ptr() for _, _, d, _ in channels))
    src_step = (ctypes.c_longlong * n)(*(a for _, a, _, _ in channels))
    dst_step = (ctypes.c_longlong * n)(*(b for _, _, _, b in channels))
    wide = (ctypes.c_int * n)(*(int(s.element_size() == 4)
                                for s, _, _, _ in channels))
    dev = perm.device
    with _build.on_device(dev):
        err = _build.library().restir_prof_permute(
            src, src_step, dst, dst_step, wide, n, min(group, n),
            _build.ptr(perm), r, int(scatter), _build.stream_of(dev))
    _build.check(err, "restir_prof_permute")
    launches["scatter" if scatter else "gather"] += 1


def _rows(t):
    """The channel rows of a [C, R] tensor (or of an [R] one)."""
    return [t] if t.dim() == 1 else [t[c] for c in range(t.shape[0])]


def gather_cols(src, perm):
    """src[:, perm] for a [C, R] float32 pack and int32 perm [R]:
    index_select on CPU tensors, the kernel on CUDA."""
    if not _cuda(src, "gather_cols"):
        return src.index_select(1, perm.long())
    _, r = src.shape
    _need(src, "src", torch.float32)
    _need(perm, "perm", torch.int32, (r,))
    dst = torch.empty_like(src)
    _permute([(s, 1, d, 1) for s, d in zip(_rows(src), _rows(dst))], perm,
             False)
    return dst


def gather_rays(perm, pos, target, live):
    """B13's any-hit inputs in the order perm: (pos[perm], target[perm],
    live[perm]) as [R, 3], [R, 3] float32 and bool [R], each written in
    B13's layout by one gather from the pixel-order tensors (index_select
    on CPU tensors)."""
    if not _cuda(pos, "gather_rays"):
        pl = perm.long()
        return pos[pl], target[pl], live[pl]
    r = pos.shape[0]
    _need(pos, "pos", torch.float32, (r, 3))
    _need(target, "target", torch.float32, (r, 3))
    _need(live, "live", torch.bool, (r,))
    _need(perm, "perm", torch.int32, (r,))
    x, y, sl = torch.empty_like(pos), torch.empty_like(target), \
        torch.empty_like(live)
    ch = [(pos[:, a], 3, x[:, a], 3) for a in range(3)]
    ch += [(target[:, a], 3, y[:, a], 3) for a in range(3)]
    _permute(ch + [(live, 1, sl, 1)], perm, False, group=3)
    return x, y, sl


def scatter_cols(src, perm):
    """out with out[..., perm] = src for src [C, R] or [R] (4-byte or
    1-byte elements) and int32 perm [R], a permutation: the inverse of
    the gather. An indexed store on CPU tensors, the kernel on CUDA."""
    out = torch.empty_like(src)
    if not _cuda(src, "scatter_cols"):
        out[..., perm.long()] = src
        return out
    r = src.shape[-1]
    _need(src, "src", src.dtype)
    _need(perm, "perm", torch.int32, (r,))
    if src.element_size() not in (1, 4) or src.dim() > 2:
        raise ValueError(f"scatter_cols: need [C, R] or [R] of 1- or 4-byte "
                         f"elements, got {src.dtype} {tuple(src.shape)}")
    _permute([(s, 1, d, 1) for s, d in zip(_rows(src), _rows(out))], perm,
             True)
    return out


def copy_pack(src):
    """A copy of a float32 pack of 4k elements (the gather's floor): clone
    on CPU tensors, the kernel on CUDA (float4 words)."""
    if not _cuda(src, "copy_pack"):
        return src.clone()
    _need(src, "src", torch.float32)
    if src.numel() % 4:
        raise ValueError(f"copy_pack: {src.numel()} floats, not a multiple "
                         f"of 4")
    dst = torch.empty_like(src)
    p = _build.ptr
    with _build.on_device(src.device):
        err = _build.library().restir_prof_copy(
            p(src), p(dst), src.numel(), _build.stream_of(src.device))
    _build.check(err, "restir_prof_copy")
    launches["copy"] += 1
    return dst


def mark(device):
    """Launch the empty marker kernel on the device's current stream."""
    dev = torch.device(device)
    with _build.on_device(dev):
        _build.check(_lib().restir_prof_mark(_build.stream_of(dev)),
                     "restir_prof_mark")


# ---- the brute-force any hit -----------------------------------------------

def plane_rows(xform, n_pad):
    """[n_pad, 12] unit-plane rows (xu, xv, xw of each triangle, zero rows
    for padding) from the scene's tri_xform [4, 3N]."""
    n = xform.shape[1] // 3
    rows = xform.reshape(4, n, 3).permute(1, 2, 0).reshape(n, 12)
    out = torch.zeros((n_pad, 12), dtype=torch.float32, device=xform.device)
    out[:n] = rows
    return out


ANYHIT_FORMS = ("fma", "mma3", "mma6")


def _rna(v):
    """v rounded to TF32 (10 mantissa bits; nearest, ties away from zero,
    as cvt.rna.tf32.f32)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, mid, lo): x = hi + mid + lo + (the rest), each a TF32 value:
    hi = tf32(x), mid = tf32(x - hi), lo = tf32(x - hi - mid)."""
    hi = _rna(x)
    rest = x - hi
    mid = _rna(rest)
    return hi, mid, _rna(rest - mid)


def split_dot(a, b, products):
    """a @ b.T from TF32 pieces, the kernel's products smallest first: 3
    (mid hi, hi mid, hi hi) or 6 (lo hi, hi lo, mid mid first)."""
    ah, am, al = tf32_split(a)
    bh, bm, bl = tf32_split(b)
    out = am @ bh.T + ah @ bm.T
    if products == 6:
        out = (al @ bh.T + ah @ bl.T + am @ bm.T) + out
    return out + ah @ bh.T


def anyhit_ref(rays, planes, split=None, chunk=8192):
    """Plain twin: bool [R], ray p (rays [8, R]: o, d, limit, pad) hits a
    plane row of planes [n_pad, 12] at 0 < t < limit. `split` 3 or 6:
    the dots from TF32 pieces, as the tensor-core forms take them."""
    r = rays.shape[1]
    xu, xv, xw = planes[:, 0:4], planes[:, 4:8], planes[:, 8:12]
    out = torch.empty(r, dtype=torch.bool, device=rays.device)
    for p0 in range(0, r, chunk):
        ry = rays[:, p0:p0 + chunk]
        o = torch.cat([ry[0:3], torch.ones_like(ry[:1])]).T
        d = torch.cat([ry[3:6], torch.zeros_like(ry[:1])]).T

        def dot(a, x):
            return a @ x.T if split is None else split_dot(a, x, split)

        oou, oov, oow = dot(o, xu), dot(o, xv), dot(o, xw)
        ddu, ddv, ddw = dot(d, xu), dot(d, xv), dot(d, xw)
        nondeg = ddw.abs() >= 1e-12
        t = -oow / torch.where(nondeg, ddw, torch.ones_like(ddw))
        u, v = oou + t * ddu, oov + t * ddv
        hit = (nondeg & (t > 0.0) & (u >= 0.0) & (v >= 0.0)
               & (u + v <= 1.0) & (t < ry[6][:, None]))
        out[p0:p0 + chunk] = hit.any(dim=1)
    return out


def _check_smem(err, what):
    """`_build.check`, but a negative code is the shared memory (bytes) a
    block of the kernel would need over the most a block can use
    (`csrc/prof/resident.cuh` kBlockSmem): a ValueError."""
    if err < 0:
        raise ValueError(f"{what}: a block would need {-err} bytes of shared "
                         "memory, over the 232448 bytes a block can use")
    _build.check(err, what)


def anyhit(rays, planes, form="fma"):
    """bool [R]: `anyhit_ref` on CPU tensors (TF32 pieces for "mma3" /
    "mma6"), `csrc/prof/anyhit.cu` on CUDA ("fma": the FP32 loop; "mma3",
    "mma6": wgmma tiles on 3xTF32 / 6xTF32 operands, the test's t from a
    reciprocal)."""
    if form not in ANYHIT_FORMS:
        raise ValueError(f"unknown any-hit form {form!r}")
    if not _cuda(rays, "anyhit"):
        return anyhit_ref(rays, planes,
                          split=None if form == "fma" else int(form[3]))
    r = rays.shape[1]
    _need(rays, "rays", torch.float32, (8, r))
    _need(planes, "planes", torch.float32, (planes.shape[0], 12))
    occ = torch.empty(r, dtype=torch.uint8, device=rays.device)
    p = _build.ptr
    with _build.on_device(rays.device):
        err = _lib().restir_prof_anyhit(p(rays), p(planes), planes.shape[0],
                                        r, ANYHIT_FORMS.index(form), p(occ),
                                        _build.stream_of(rays.device))
    _check_smem(err, f"anyhit {form} on {planes.shape[0]} rows")
    launches["anyhit_" + form] += 1
    return occ.bool()


# ---- memory paths ----------------------------------------------------------

def gather_index(r, k, device):
    """prof_gather's index: (i * 7919) % k, int32 [r]."""
    return ((torch.arange(r, device=device, dtype=torch.int64) * 7919)
            % k).to(torch.int32)


def texture(table):
    """A texture object (an int handle) over a CUDA float32 table [K], for
    `table_gather(..., "tex", tex=...)`; free it with `free_texture`."""
    tex = ctypes.c_uint64(0)
    with _build.on_device(table.device):
        _build.check(_lib().restir_prof_tex(_build.ptr(table), table.shape[0],
                                            1, ctypes.byref(tex)),
                     "restir_prof_tex")
    return tex.value


def free_texture(tex):
    _build.check(_lib().restir_prof_tex(None, 0, 0,
                                        ctypes.byref(ctypes.c_uint64(tex))),
                 "restir_prof_tex")


def table_gather(table, idx, where="ldg", tex=None):
    """table[idx] (table float32 [K], idx int32 [R]): index_select on CPU
    tensors, `csrc/prof/mem.cu` on CUDA from shared memory (K * 4 bytes
    at most 232,448; idx 16-byte aligned), __ldg or a texture object
    (`tex`, from `texture(table)`)."""
    if where not in GATHER_WHERE:
        raise ValueError(f"unknown gather source {where!r}")
    if not _cuda(table, "table_gather"):
        return table.index_select(0, idx.long())
    k, r = table.shape[0], idx.shape[0]
    _need(table, "table", torch.float32, (k,))
    _need(idx, "idx", torch.int32, (r,))
    if where == "tex" and tex is None:
        raise ValueError("table_gather from a texture needs `tex`")
    out = torch.empty(r, dtype=torch.float32, device=table.device)
    p, dev = _build.ptr, table.device
    if where == "shared" and idx.data_ptr() % 16:
        raise ValueError("table_gather from shared memory: idx must be "
                         "16-byte aligned (int4 loads)")
    with _build.on_device(dev):
        err = _lib().restir_prof_table_gather(
            p(table), k, p(idx), r, GATHER_WHERE.index(where),
            ctypes.c_uint64(tex or 0), p(out), _build.stream_of(dev))
    _check_smem(err, f"table_gather {where} of {k} floats")
    launches["table_gather_" + where] += 1
    return out


def chain_inputs(pack, layout):
    """The chain's inputs in a layout, from an [8, R] pack (a, b, m,
    pad): (in, in2, m) as the kernel takes them."""
    if layout == "soa":
        return pack.contiguous(), None, None
    if layout == "aos":
        return (pack[0:3].T.contiguous(), pack[3:6].T.contiguous(),
                pack[6].contiguous())
    if layout == "float4":
        zero = torch.zeros_like(pack[7])
        return (torch.stack([pack[0], pack[1], pack[2], pack[6]], 1)
                .contiguous(),
                torch.stack([pack[3], pack[4], pack[5], zero], 1)
                .contiguous(), None)
    raise ValueError(f"unknown chain layout {layout!r}")


def chain_ref(pack):
    """Plain twin: [3, R] after 90 rounds of a = m ? a c_i + b : a on an
    [8, R] pack (a 0:3, b 3:6, m 6), each round a rounded product then a
    rounded sum."""
    a = [pack[i] for i in range(3)]
    b = [pack[3 + i] for i in range(3)]
    m = pack[6] > 0.5
    for c in CHAIN_FACTORS:
        cv = torch.tensor(c, dtype=torch.float32, device=pack.device)
        a = [torch.where(m, ai * cv + bi, ai) for ai, bi in zip(a, b)]
    return torch.stack(a)


def chain(pack, layout="soa"):
    """[3, R]: `chain_ref` on CPU tensors, `csrc/prof/mem.cu` on CUDA with
    the pack laid out as `layout` first (`chain_laid` times the kernel
    alone)."""
    if not _cuda(pack, "chain"):
        chain_inputs(pack, layout)  # checks the layout's name
        return chain_ref(pack)
    _need(pack, "pack", torch.float32, (8, pack.shape[1]))
    return chain_laid(chain_inputs(pack, layout), layout)


def chain_laid(inputs, layout):
    """The chain kernel on inputs already in `layout` (`chain_inputs`):
    [3, R] (a view of the kernel's [R, 3] / [R, 4] output for "aos" /
    "float4")."""
    src, src2, m = inputs
    r = src.shape[1] if layout == "soa" else src.shape[0]
    shape = {"soa": (3, r), "aos": (r, 3), "float4": (r, 4)}[layout]
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    p = _build.ptr
    with _build.on_device(src.device):
        err = _lib().restir_prof_chain(p(src), p(src2), p(m), r,
                                       CHAIN_LAYOUTS.index(layout), p(out),
                                       _build.stream_of(src.device))
    _build.check(err, "restir_prof_chain")
    launches["chain_" + layout] += 1
    if layout == "soa":
        return out
    return out[:, :3].T
