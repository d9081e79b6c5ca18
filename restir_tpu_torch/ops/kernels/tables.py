"""Scene tables of the DI kernels, built once per scene upload.

`restir_tpu.ops.pallas.fused_di` rebuilds these every frame inside its
jitted step (`_resident_tables`, `ris_kernel.build_light_tables`); here
they are host numpy, built once at upload, so the CPU twin and the CUDA
kernel read bit-identical tables. Row-major per triangle / light, so a
thread's fetch of one row is contiguous.

- `planes` [n_pad, 12]: unit-triangle transform rows (xu 0:4, xv 4:8,
  xw 8:12); zero rows pad n to n_pad = round_up(max(n, 128), 64) and
  never hit (dd.w == 0).
- `attr` [n, 32] packed attribute rows; `mat` [m, 16] material rows.
- `lights` [l_pad, 16]: v0(3) e1(3) e2(3) normal(3) radiance(3) area(1).
- `psi` [l_pad, 16]: the target-weight rows psi_a(4) psi_b(4) psi_c(5)
  lum*area and radius (2), pad(1); l_pad = round_up(max(nl, 128), 128)
  with zero rows, as `di_resident_pallas` pads them (a pick past the
  last light clamps to row l_pad - 1).
- `env_lights` / `env_psi`: the same tables with the scene's 512 env
  tiles joined as virtual lights after the nl area rows
  (`ris_kernel.build_light_tables`' env rows: psi_a = (d_tile, 0),
  psi_b = (0, 0, 0, 1), psi_c = (0, 0, 0, 1, 0), lum * solid angle and
  the tile's angular radius; light rows (u0, v0, 0 | du, 0, 0 | dv, 0, 0 |
  0 | radiance | solid angle)), l_pad = round_up(nl + 512, 128); None
  without an env map. A frame with `has_env_map` samples these.
- `env_rad` [512, 4]: tile radiance (rgb, 0) for miss pixels ([1, 4]
  zeros without an env map).
- `atlas` [rows_pad * 128, 4]: the mip-clamped texel rows of
  `scene_data._build_fused_atlas` as (r, g, b, 0) texels, row y of the
  atlas at [y * 128, y * 128 + 128); `tex_meta` [T_pad, 4] (row0, width,
  height, valid) per texture.
- `gi_tri` [n, 32]: the rows kernel B8 interpolates at a hit, as
  `ops.surface.make_interaction` reads them: vertices v0 v1 v2 (0:9),
  vertex normals (9:18), vertex uvs (18:24), material id (24), pad.
- `gi_lights` [Ls, 8]: B8's alias-table light rows, one per alias slot i:
  probability, alias, the light's triangle `light_prim_ids[min(i, L-1)]`,
  its radiance `light_radiance[min(i, Lr-1)]` (3), pad: the clamps of
  `ops.lights.sample_direct_light_no_visibility`, applied once here.
- `sum_light_power_inv`: the scene's float32 scalar, on the host.

`BvhTables` is the device layout the MTBVH kernels (B1a `fused_di.cu`, B6
`gbuffer_bvh.cu`, B7 `reuse_bvh.cu`, B8 `gi_trace.cu`) walk, with the JAX
tables' `box_id` indirection resolved at upload:

- `planes`, `attr`, `mat`, `env_rad`, `atlas`, `tex_meta`: the resident
  tables' tensors; a leaf's primitive id indexes the rows directly;
- `rows` [6B, 8] float32: table t's node j at row t * B + j, its box
  lo(3), prim (int32 bits), box hi(3), miss (int32 bits): one 32-byte
  load per visited node, and no second load that waits on the first for
  the box. The boxes are `padded_bounds`: each face moved outward by
  BOX_PAD_REL of the scene's largest coordinate and rounded outward to
  float32, so the float32 slab test never culls a box whose triangle the
  unit-plane leaf test hits (the leaf test and the slab test round
  differently; an unpadded flat box, such as a floor's, can lose a hit
  on its edge).

`WalkTables` is what the JAX package's own lockstep walk reads (the
general path's intersector for every name but "brute"), for its plain
twin in `ops.intersect` and kernels B13 / B14: the raw `verts`, unpadded
node boxes and flat MTBVH tables, and as the kernels read them `rows`
[6B, 8] (`node_rows`' layout with each node's exact box) and `vert_rows`
[n_pad, 12] (v0, v1, v2, pad). `LazyWalkTables` builds them on first use.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

LIGHT_COLS = 16
PSI_COLS = 16
PLANE_COLS = 12
_PI = 3.14159265358979  # ris_kernel._PI


BOX_PAD_REL = 2.0 ** -16  # box padding, relative to the scene's extent
BOUND_COLS = 8


ENV_COLS = 4
TEX_W = 128  # texels per atlas row (scene_data.FUSED_TEX_MAX_W)


class ResidentTables(NamedTuple):
    planes: torch.Tensor  # [n_pad, 12] f32
    attr: torch.Tensor  # [n, 32] f32
    mat: torch.Tensor  # [m, 16] f32
    lights: torch.Tensor  # [l_pad, 16] f32
    psi: torch.Tensor  # [l_pad, 16] f32
    n_lights: int
    env_lights: Optional[torch.Tensor]  # [l_pad_env, 16] f32, or None
    env_psi: Optional[torch.Tensor]  # [l_pad_env, 16] f32, or None
    env_rad: torch.Tensor  # [512, 4] f32 ([1, 4] zeros without env)
    atlas: torch.Tensor  # [rows_pad * 128, 4] f32
    tex_meta: torch.Tensor  # [T_pad, 4] f32
    gi_tri: torch.Tensor  # [n, 32] f32
    gi_lights: torch.Tensor  # [Ls, 8] f32
    sum_light_power_inv: float

    def light_rows(self, has_env: bool):
        """(lights, psi) a frame samples: with the env tiles when
        `has_env`, which needs a scene with an env map."""
        if not has_env:
            return self.lights, self.psi
        if self.env_lights is None:
            raise ValueError("has_env_map is set but the scene has no env map")
        return self.env_lights, self.env_psi


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plane_table(tri_xform: np.ndarray) -> np.ndarray:
    n = tri_xform.shape[1] // 3
    n_pad = _round_up(max(n, 128), 64)
    x = np.asarray(tri_xform, np.float32).reshape(4, n, 3)
    planes = np.zeros((n_pad, PLANE_COLS), np.float32)
    for k in range(3):
        planes[:n, 4 * k:4 * k + 4] = x[:, :, k].T
    return planes


def light_tables(light_verts, light_normal, light_radiance, light_area,
                 light_center, light_radius, env_tile_rad=None,
                 env_tile_uv=None, env_tile_sa=None):
    """(lights [l_pad, 16], psi [l_pad, 16]) in float32, with the same
    rows as `ris_kernel.build_light_tables`: the area lights, then the env
    tiles when they are given."""
    nl = light_verts.shape[0]
    n_env = 0 if env_tile_rad is None else env_tile_rad.shape[0]
    l_pad = _round_up(max(nl + n_env, 128), 128)
    lv9 = np.asarray(light_verts, np.float32).reshape(nl, 9)
    ln = np.asarray(light_normal, np.float32)
    lr = np.asarray(light_radiance, np.float32)
    la = np.asarray(light_area, np.float32)
    lc = np.asarray(light_center, np.float32)
    lrad = np.asarray(light_radius, np.float32)

    lights = np.zeros((l_pad, LIGHT_COLS), np.float32)
    lights[:nl, 0:3] = lv9[:, 0:3]
    lights[:nl, 3:6] = lv9[:, 3:6] - lv9[:, 0:3]
    lights[:nl, 6:9] = lv9[:, 6:9] - lv9[:, 0:3]
    lights[:nl, 9:12] = ln
    lights[:nl, 12:15] = lr
    lights[:nl, 15] = la

    psi = np.zeros((l_pad, PSI_COLS), np.float32)
    psi[:nl, 0:3] = lc  # psi_a = (c, 1): a = n.c - n.p
    psi[:nl, 3] = 1.0
    psi[:nl, 4:7] = ln  # psi_b = (ln, -ln.c): b = ln.(p - c)
    psi[:nl, 7] = -(ln[:, 0] * lc[:, 0] + ln[:, 1] * lc[:, 1]
                    + ln[:, 2] * lc[:, 2])
    psi[:nl, 8:11] = lc  # psi_c = (c, |c|^2, 1): d2 = |p - c|^2
    psi[:nl, 11] = lc[:, 0] * lc[:, 0] + lc[:, 1] * lc[:, 1] + lc[:, 2] * lc[:, 2]
    psi[:nl, 12] = 1.0
    psi[:nl, 13] = la * (0.2126 * lr[:, 0] + 0.7152 * lr[:, 1]
                         + 0.0722 * lr[:, 2])
    psi[:nl, 14] = lrad
    if n_env:
        euv = np.asarray(env_tile_uv, np.float32)
        erad = np.asarray(env_tile_rad, np.float32)
        esa = np.asarray(env_tile_sa, np.float32)
        pi = np.float32(_PI)
        # tile-centre directions (to_sphere), float32 as the JAX rows
        uc = (euv[:, 0] + np.float32(0.5) * euv[:, 2]) * np.float32(2.0 * _PI)
        vc = (euv[:, 1] + np.float32(0.5) * euv[:, 3]) * pi
        st = np.sin(vc)
        e = slice(nl, nl + n_env)
        psi[e, 0] = np.cos(uc) * st  # psi_a = (d_tile, 0): a = n.d
        psi[e, 1] = np.cos(vc)
        psi[e, 2] = np.sin(uc) * st
        psi[e, 7] = 1.0  # psi_b = (0, 0, 0, 1): b = 1
        psi[e, 11] = 1.0  # psi_c = (0, 0, 0, 1, 0): d2 = 1
        psi[e, 13] = (np.float32(0.2126) * erad[:, 0]
                      + np.float32(0.7152) * erad[:, 1]
                      + np.float32(0.0722) * erad[:, 2]) * esa
        psi[e, 14] = np.float32(0.5) * np.sqrt(
            (pi * euv[:, 3]) ** 2 + (np.float32(2.0 * _PI) * euv[:, 2]) ** 2)
        lights[e, 0] = euv[:, 0]  # u0
        lights[e, 1] = euv[:, 1]  # v0
        lights[e, 3] = euv[:, 2]  # du
        lights[e, 6] = euv[:, 3]  # dv
        lights[e, 12:15] = erad
        lights[e, 15] = esa
    return lights, psi


def env_radiance_table(env_tile_rad) -> np.ndarray:
    """[ET, 4] (r, g, b, 0) tile radiance rows."""
    rad = np.asarray(env_tile_rad, np.float32)
    out = np.zeros((rad.shape[0], ENV_COLS), np.float32)
    out[:, 0:3] = rad
    return out


def atlas_texels(fused_atlas) -> np.ndarray:
    """The JAX [384, rows_pad] atlas as [rows_pad * 128, 4] texel rows."""
    a = np.asarray(fused_atlas, np.float32)
    rows = a.shape[1]
    out = np.zeros((rows, TEX_W, 4), np.float32)
    out[..., 0:3] = a.reshape(3, TEX_W, rows).transpose(2, 1, 0)
    return out.reshape(rows * TEX_W, 4)


def has_env_map(arrays) -> bool:
    env = np.asarray(arrays["env_map"])
    return bool(env.shape[0] > 1 or env.shape[1] > 1)


GI_TRI_COLS = 32
GI_LIGHT_COLS = 8


def gi_tables(arrays):
    """(gi_tri, gi_lights) in float32 from scene arrays."""
    verts = np.asarray(arrays["verts"], np.float32)
    n = verts.shape[0]
    tri = np.zeros((n, GI_TRI_COLS), np.float32)
    tri[:, 0:9] = verts.reshape(n, 9)
    tri[:, 9:18] = np.asarray(arrays["norms"], np.float32).reshape(n, 9)
    tri[:, 18:24] = np.asarray(arrays["uvs"], np.float32).reshape(n, 6)
    tri[:, 24] = np.asarray(arrays["mat_ids"])
    prob = np.asarray(arrays["light_prob"], np.float32)
    prims = np.asarray(arrays["light_prim_ids"])
    rad = np.asarray(arrays["light_radiance"], np.float32)
    slots = np.arange(prob.shape[0])
    lights = np.zeros((prob.shape[0], GI_LIGHT_COLS), np.float32)
    lights[:, 0] = prob
    lights[:, 1] = np.asarray(arrays["light_alias"])
    if prims.shape[0]:
        lights[:, 2] = prims[np.minimum(slots, prims.shape[0] - 1)]
    if rad.shape[0]:
        lights[:, 3:6] = rad[np.minimum(slots, rad.shape[0] - 1)]
    return tri, lights


def build_resident_tables(arrays, device) -> ResidentTables:
    """Tables from a mapping of scene arrays (numpy, SceneData names)."""
    light_args = [arrays[k] for k in (
        "light_verts", "light_normal", "light_radiance", "light_area",
        "light_center", "light_radius")]
    lights, psi = light_tables(*light_args)

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32),
                               device=device)

    env_lights = env_psi = None
    if has_env_map(arrays):
        env_lights, env_psi = (dev(t) for t in light_tables(
            *light_args, arrays["env_tile_rad"], arrays["env_tile_uv"],
            arrays["env_tile_sa"]))
    tri_xform = np.asarray(arrays["tri_xform"], np.float32)
    gi_tri, gi_lights = gi_tables(arrays)
    return ResidentTables(
        planes=dev(plane_table(tri_xform)),
        attr=dev(arrays["prim_attr"]),
        mat=dev(arrays["mat_attr"]),
        lights=dev(lights),
        psi=dev(psi),
        n_lights=int(np.asarray(arrays["light_verts"]).shape[0]),
        env_lights=env_lights,
        env_psi=env_psi,
        env_rad=dev(env_radiance_table(arrays["env_tile_rad"])),
        atlas=dev(atlas_texels(arrays["fused_atlas"])),
        tex_meta=dev(arrays["fused_tex_meta"]),
        gi_tri=dev(gi_tri),
        gi_lights=dev(gi_lights),
        sum_light_power_inv=float(np.float32(
            arrays["sum_light_power_inv"])),
    )


class BvhTables(NamedTuple):
    planes: torch.Tensor  # [n_pad, 12] f32 (ResidentTables.planes)
    attr: torch.Tensor  # [n, 32] f32
    mat: torch.Tensor  # [m, 16] f32
    rows: torch.Tensor  # [6B, 8] f32 node rows with their padded boxes
    size: int  # B
    env_rad: torch.Tensor  # ResidentTables.env_rad
    atlas: torch.Tensor  # ResidentTables.atlas
    tex_meta: torch.Tensor  # ResidentTables.tex_meta


def padded_bounds(bounds_lo, bounds_hi) -> np.ndarray:
    """[B, 8] node boxes moved outward by BOX_PAD_REL of the scene's
    largest coordinate, rounded outward to float32."""
    lo = np.asarray(bounds_lo, np.float64)
    hi = np.asarray(bounds_hi, np.float64)
    scale = max(float(np.abs(lo).max()), float(np.abs(hi).max()), 1.0)
    pad = BOX_PAD_REL * scale
    lo32 = np.nextafter((lo - pad).astype(np.float32), np.float32(-np.inf))
    hi32 = np.nextafter((hi + pad).astype(np.float32), np.float32(np.inf))
    out = np.zeros((lo.shape[0], BOUND_COLS), np.float32)
    out[:, 0:3] = lo32
    out[:, 4:7] = hi32
    return out


def node_rows(arrays) -> np.ndarray:
    """[6B, 8] float32 node rows from the flat MTBVH tables of a mapping
    of scene arrays: padded box lo(3), prim (int32 bits), padded box
    hi(3), miss (int32 bits)."""
    return _with_links(padded_bounds(arrays["bounds_lo"],
                                     arrays["bounds_hi"]), arrays)


def _with_links(bounds, arrays) -> np.ndarray:
    """Node rows: box rows [B, 8] gathered by the MTBVH tables, prim and
    miss in the int32 bits of columns 3 and 7."""
    box = np.asarray(arrays["bvh_box"], np.int32).reshape(-1)
    if box.shape[0] != 6 * bounds.shape[0]:
        raise ValueError(f"MTBVH tables hold {box.shape[0]} rows, "
                         f"expected 6 x {bounds.shape[0]}")
    rows = bounds[box]
    bits = rows.view(np.int32)
    bits[:, 3] = np.asarray(arrays["bvh_prim"], np.int32).reshape(-1)
    bits[:, 7] = np.asarray(arrays["bvh_miss"], np.int32).reshape(-1)
    return rows


class WalkTables(NamedTuple):
    """What the JAX package's lockstep MTBVH walk reads
    (`restir_tpu.ops.intersect.TraversalArrays`), and the same as the
    rows kernels B13 / B14 read."""

    verts: torch.Tensor  # [N, 3, 3] f32
    bounds_lo: torch.Tensor  # [B, 3] f32 node boxes, unpadded
    bounds_hi: torch.Tensor  # [B, 3]
    prim_flat: torch.Tensor  # [6B] i32
    box_flat: torch.Tensor  # [6B] i32
    miss_flat: torch.Tensor  # [6B] i32
    rows: torch.Tensor  # [6B, 8] f32 node rows with their exact boxes
    vert_rows: torch.Tensor  # [n_pad, 12] f32: v0, v1, v2, pad
    size: int  # B


def exact_node_rows(arrays) -> np.ndarray:
    """[6B, 8] float32 node rows as `node_rows`, with each node's own
    (unpadded) box: the JAX walk tests the raw box against a strict
    t_near < best, so a padded box would visit other nodes. B14's walk
    picks each box's near plane from the ray's signs, which needs lo <= hi
    on every axis of every box: a box that breaks it (or holds a NaN)
    raises ValueError."""
    lo = np.asarray(arrays["bounds_lo"], np.float32)
    hi = np.asarray(arrays["bounds_hi"], np.float32)
    bad = np.flatnonzero(~(lo <= hi).all(axis=1))
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"node box {i} of the MTBVH has lo {lo[i].tolist()} "
                         f"above hi {hi[i].tolist()} ({bad.size} such "
                         "boxes): the walk's tables need lo <= hi")
    bounds = np.zeros((lo.shape[0], BOUND_COLS), np.float32)
    bounds[:, 0:3] = lo
    bounds[:, 4:7] = hi
    return _with_links(bounds, arrays)


def vertex_rows(verts) -> np.ndarray:
    """[n_pad, 12] float32 rows v0, v1, v2 and three zeros (a leaf reads
    three float4), n_pad as the plane rows'."""
    v = np.asarray(verts, np.float32).reshape(-1, 9)
    rows = np.zeros((_round_up(max(v.shape[0], 128), 64), PLANE_COLS),
                    np.float32)
    rows[:v.shape[0], 0:9] = v
    return rows


def build_walk_tables(arrays, verts: torch.Tensor) -> WalkTables:
    """WalkTables on `verts`' device from a mapping of scene arrays."""
    dev = verts.device

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=dev)

    return WalkTables(
        verts=verts, bounds_lo=t("bounds_lo", torch.float32),
        bounds_hi=t("bounds_hi", torch.float32),
        prim_flat=t("bvh_prim", torch.int32).reshape(-1),
        box_flat=t("bvh_box", torch.int32).reshape(-1),
        miss_flat=t("bvh_miss", torch.int32).reshape(-1),
        rows=torch.from_numpy(exact_node_rows(arrays)).to(dev),
        vert_rows=torch.from_numpy(vertex_rows(arrays["verts"])).to(dev),
        size=int(np.asarray(arrays["bounds_lo"]).shape[0]))


class LazyWalkTables:
    """WalkTables built on the first `get()`: only scenes whose config
    takes the walk (or the heatmap) pay for them (the hall's node rows
    are 31 MB)."""

    _KEYS = ("verts", "bounds_lo", "bounds_hi", "bvh_prim", "bvh_box",
             "bvh_miss")

    def __init__(self, arrays, verts: torch.Tensor):
        self._arrays = {k: np.asarray(arrays[k]) for k in self._KEYS}
        self._verts = verts
        self._tables: Optional[WalkTables] = None

    @property
    def built(self) -> bool:
        return self._tables is not None

    def get(self) -> WalkTables:
        if self._tables is None:
            self._tables = build_walk_tables(self._arrays, self._verts)
        return self._tables


def build_bvh_tables(arrays, resident: ResidentTables, device) -> BvhTables:
    """MTBVH tables from a mapping of scene arrays (numpy, SceneData
    names), sharing the resident tables' plane, attribute and material
    rows."""
    return BvhTables(
        planes=resident.planes,
        attr=resident.attr,
        mat=resident.mat,
        rows=torch.from_numpy(node_rows(arrays)).to(device),
        size=int(np.asarray(arrays["bounds_lo"]).shape[0]),
        env_rad=resident.env_rad,
        atlas=resident.atlas,
        tex_meta=resident.tex_meta,
    )
