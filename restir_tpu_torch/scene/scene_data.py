"""Scene build (numpy, host) and the device scene of the port.

`build_scene` follows `restir_tpu.scene.scene_data.build_scene` for the
arrays the port reads: the world-space triangle soup in the
same Morton order (primitive ids appear in the G-buffer and in the
shadow-ray self-exclusion, so the order must match), the SAH/MTBVH built
on the permuted triangles (`scene.bvh`), the unit-triangle transforms,
the packed attribute and material rows, the light geometry, the raw env
map and packed textures, and what the fused kernels sample of them: the
16 x 32 piecewise-constant env tiles and the mip-clamped texture atlas
(textures box-mipped to <= 128 texels wide within 256 rows), both equal
to the JAX leaves; and what the general path reads: the light and env
alias tables (`scene.alias_table`, light power = luminance * 2 pi *
area), 1 / the summed power, and the per-material arrays. The TPU
cluster / sub-block work-list boxes are not built: the port does not
read them.

`SceneTensors` is the same data as torch tensors on one device, plus
the kernel tables derived from it once at upload
(`ops.kernels.tables.ResidentTables` and `BvhTables`), and those of the
exact MTBVH walk (`WalkTables`), built on first use.
`traversal_method` picks the general path's intersector as the JAX
package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .alias_table import build_alias_table
from .bvh import build_bvh
from .mesh import LIGHT, MaterialDesc, MeshInstance, build_transformation_matrix

ATTR_COLS = 32  # v0(3) e01(3) e02(3) n0(3) n01(3) n02(3) t0(2) t01(2) t02(2) mat_id(1)
MAT_COLS = 16  # type(1) base_color(3) metallic(1) roughness(1) ior(1) maps(4)


class SceneArrays(NamedTuple):
    """Host scene (numpy). Field names and values equal the JAX
    `SceneData` leaves of the same name."""

    verts: np.ndarray  # [N, 3, 3] f32, Morton order
    norms: np.ndarray  # [N, 3, 3]
    uvs: np.ndarray  # [N, 3, 2]
    mat_ids: np.ndarray  # [N] i32
    bounds_lo: np.ndarray  # [B, 3] f32 BVH node boxes, B = 2N - 1
    bounds_hi: np.ndarray  # [B, 3]
    bvh_prim: np.ndarray  # [6B] i32 MTBVH tables (scene.bvh), flat
    bvh_box: np.ndarray  # [6B] i32
    bvh_miss: np.ndarray  # [6B] i32
    tri_xform: np.ndarray  # [4, 3N] unit-triangle transforms
    prim_attr: np.ndarray  # [N, ATTR_COLS]
    mat_attr: np.ndarray  # [M, MAT_COLS]
    mat_type: np.ndarray  # [M] i32
    light_prim_ids: np.ndarray  # [L] i32
    light_radiance: np.ndarray  # [L, 3]
    light_verts: np.ndarray  # [L, 3, 3]
    light_normal: np.ndarray  # [L, 3]
    light_area: np.ndarray  # [L]
    light_center: np.ndarray  # [L, 3]
    light_radius: np.ndarray  # [L]
    env_map: np.ndarray  # [Eh, Ew, 3] f32; [1, 1, 3] zeros when absent
    tex_data: np.ndarray  # [K, 3] packed texels; [1, 3] zeros when none
    tex_offset: np.ndarray  # [T] i32
    tex_width: np.ndarray  # [T] i32
    tex_height: np.ndarray  # [T] i32
    env_tile_rad: np.ndarray  # [ET, 3] f32 tile mean radiance; [1, 3] zeros
    env_tile_uv: np.ndarray  # [ET, 4] (u0, v0, du, dv); [1, 4] zeros
    env_tile_sa: np.ndarray  # [ET] tile solid angle; [1] zeros
    fused_atlas: np.ndarray  # [384, rows_pad]: [c*128 + x, row0 + y] = texel
    fused_tex_meta: np.ndarray  # [T_pad, 4] (row0, w, h, valid)
    light_prob: np.ndarray  # [Ls] f32 alias table over lights (+1 env)
    light_alias: np.ndarray  # [Ls] i32
    sum_light_power_inv: np.ndarray  # f32 scalar (0 without lights)
    env_prob: np.ndarray  # [Eh*Ew] f32 env texel alias table
    env_alias: np.ndarray  # [Eh*Ew] i32
    mat_base_color: np.ndarray  # [M, 3] f32
    mat_metallic: np.ndarray  # [M]
    mat_roughness: np.ndarray  # [M]
    mat_ior: np.ndarray  # [M]
    mat_base_map: np.ndarray  # [M] i32 (-1 none, -2 procedural)
    mat_metallic_map: np.ndarray  # [M] i32
    mat_roughness_map: np.ndarray  # [M] i32
    mat_normal_map: np.ndarray  # [M] i32


class SceneTensors(NamedTuple):
    """Device scene: the fused kernels' tables and the arrays the general
    path reads (JAX `SceneData` names)."""

    tri_xform: torch.Tensor
    prim_attr: torch.Tensor
    mat_attr: torch.Tensor
    mat_type: torch.Tensor
    light_verts: torch.Tensor
    light_normal: torch.Tensor
    light_radiance: torch.Tensor
    light_area: torch.Tensor
    light_center: torch.Tensor
    light_radius: torch.Tensor
    tables: "object"  # ops.kernels.tables.ResidentTables
    bvh: "object"  # ops.kernels.tables.BvhTables
    walk: "object"  # ops.kernels.tables.LazyWalkTables (built on first use)
    has_env_map: bool  # the scene has an environment map
    has_textures: bool  # a material reads a texture
    verts: torch.Tensor  # [N, 3, 3]
    norms: torch.Tensor  # [N, 3, 3]
    uvs: torch.Tensor  # [N, 3, 2]
    mat_ids: torch.Tensor  # [N] i32
    light_prim_ids: torch.Tensor  # [L] i32
    light_prob: torch.Tensor  # [Ls]
    light_alias: torch.Tensor  # [Ls] i32
    sum_light_power_inv: torch.Tensor  # f32 scalar
    env_map: torch.Tensor  # [Eh, Ew, 3]
    env_prob: torch.Tensor  # [Eh*Ew]
    env_alias: torch.Tensor  # [Eh*Ew] i32
    env_tile_rad: torch.Tensor  # [ET, 3]
    env_tile_uv: torch.Tensor  # [ET, 4]
    env_tile_sa: torch.Tensor  # [ET]
    tex_data: torch.Tensor  # [K, 3]
    tex_offset: torch.Tensor  # [T] i32
    tex_width: torch.Tensor  # [T] i32
    tex_height: torch.Tensor  # [T] i32
    mat_base_color: torch.Tensor  # [M, 3]
    mat_metallic: torch.Tensor  # [M]
    mat_roughness: torch.Tensor  # [M]
    mat_ior: torch.Tensor  # [M]
    mat_base_map: torch.Tensor  # [M] i32
    mat_metallic_map: torch.Tensor  # [M] i32
    mat_roughness_map: torch.Tensor  # [M] i32
    mat_normal_map: torch.Tensor  # [M] i32

    @property
    def num_tris(self) -> int:
        return self.tri_xform.shape[1] // 3


BRUTE_FORCE_MAX_PRIMS = 16384  # restir_tpu.scene.scene_data's limit


def traversal_method(scene, intersector: str = "auto") -> str:
    """The general path's intersector for a scene, as
    `restir_tpu.scene.scene_data.traversal_method`: "auto" takes "brute"
    up to BRUTE_FORCE_MAX_PRIMS triangles and "bvh" above, with a
    warning; any other name passes through ("brute" at any size; "bvh",
    "clustered" and the rest take the MTBVH walk)."""
    if intersector == "auto":
        n = scene.verts.shape[0]
        if n > BRUTE_FORCE_MAX_PRIMS:
            import warnings

            warnings.warn(
                f"scene has {n} triangles (> {BRUTE_FORCE_MAX_PRIMS}): "
                "this tracer takes the lockstep-BVH walk (kernel B13 on "
                "the card). The fused RESTIR_DI path has no triangle-count "
                "ceiling.", stacklevel=2)
        intersector = "brute" if n <= BRUTE_FORCE_MAX_PRIMS else "bvh"
    return intersector


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Permutation sorting points along a 30-bit 3-D Morton curve."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def build_tri_transforms(vertices: np.ndarray) -> np.ndarray:
    """[4, 3N] affine maps into unit-triangle (u, v, w) space: for
    (v0, v1, v2), M = [e1 e2 n]^-1 and the last row folds in -M v0.
    Degenerate triangles get a zero matrix (never hit)."""
    tris = np.asarray(vertices, np.float64).reshape(-1, 3, 3)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    mats = np.stack([e1, e2, n], axis=-1)
    dets = np.linalg.det(mats)
    ok = np.abs(dets) > 1e-18
    inv = np.zeros_like(mats)
    if ok.any():
        inv[ok] = np.linalg.inv(mats[ok])
    trans = -np.einsum("nij,nj->ni", inv, v0)
    a = np.concatenate([inv, trans[..., None]], axis=-1)  # [N, 3, 4]
    packed = a.transpose(2, 0, 1).reshape(4, -1)
    return np.ascontiguousarray(packed.astype(np.float32))


def build_prim_attr(verts, norms, uvs, mat_ids) -> np.ndarray:
    v = np.asarray(verts, np.float32)
    n = np.asarray(norms, np.float32)
    t = np.asarray(uvs, np.float32)
    a = np.zeros((v.shape[0], ATTR_COLS), np.float32)
    a[:, 0:3] = v[:, 0]
    a[:, 3:6] = v[:, 1] - v[:, 0]
    a[:, 6:9] = v[:, 2] - v[:, 0]
    a[:, 9:12] = n[:, 0]
    a[:, 12:15] = n[:, 1] - n[:, 0]
    a[:, 15:18] = n[:, 2] - n[:, 0]
    a[:, 18:20] = t[:, 0]
    a[:, 20:22] = t[:, 1] - t[:, 0]
    a[:, 22:24] = t[:, 2] - t[:, 0]
    a[:, 24] = np.asarray(mat_ids, np.float32)
    return a


def build_mat_attr(materials: Sequence[MaterialDesc]) -> np.ndarray:
    a = np.zeros((len(materials), MAT_COLS), np.float32)
    a[:, 0] = np.asarray([m.type for m in materials], np.float32)
    a[:, 1:4] = np.asarray([m.base_color for m in materials], np.float32)
    a[:, 4] = np.asarray([m.metallic for m in materials], np.float32)
    a[:, 5] = np.asarray([m.roughness for m in materials], np.float32)
    a[:, 6] = np.asarray([m.ior for m in materials], np.float32)
    a[:, 7] = np.asarray([m.base_map for m in materials], np.float32)
    a[:, 8] = np.asarray([m.metallic_map for m in materials], np.float32)
    a[:, 9] = np.asarray([m.roughness_map for m in materials], np.float32)
    a[:, 10] = np.asarray([m.normal_map for m in materials], np.float32)
    return a


def _pack_textures(textures):
    """(tex_data, tex_offset, tex_width, tex_height) as the JAX build packs
    them: row-major texels of every texture back to back."""
    if not textures:
        return (np.zeros((1, 3), np.float32), np.zeros(1, np.int32),
                np.ones(1, np.int32), np.ones(1, np.int32))
    offsets, widths, heights, datas = [], [], [], []
    off = 0
    for t in textures:
        t = np.asarray(t, np.float32)  # [h, w, 3]
        offsets.append(off)
        widths.append(t.shape[1])
        heights.append(t.shape[0])
        datas.append(t.reshape(-1, 3))
        off += t.shape[0] * t.shape[1]
    return (np.concatenate(datas), np.asarray(offsets, np.int32),
            np.asarray(widths, np.int32), np.asarray(heights, np.int32))


TWO_PI = 2.0 * np.pi


def _luminance_np(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


ENV_TILE_H = 16  # env tile grid of the fused kernels
ENV_TILE_W = 32


def _build_env_tiles(env: np.ndarray):
    """Solid-angle-weighted ENV_TILE_H x ENV_TILE_W downsample of the
    equirect env map: per tile (mean radiance, uv rect, solid angle). The
    fused kernels render and sample this piecewise-constant env."""
    eh, ew = env.shape[0], env.shape[1]
    th, tw = ENV_TILE_H, ENV_TILE_W
    row = (np.arange(eh, dtype=np.float64) + 0.5) / eh
    sin_theta = np.sin(row * np.pi)
    ty = np.minimum((np.arange(eh) * th) // eh, th - 1).astype(np.int64)
    tx = np.minimum((np.arange(ew) * tw) // ew, tw - 1).astype(np.int64)
    tidx = (ty[:, None] * tw + tx[None, :]).reshape(-1)
    w = np.broadcast_to(sin_theta[:, None], (eh, ew)).reshape(-1)
    wsum = np.zeros(th * tw)
    np.add.at(wsum, tidx, w)
    rad = np.zeros((th * tw, 3))
    for c in range(3):
        np.add.at(rad[:, c], tidx, w * env[..., c].reshape(-1))
    rad /= np.maximum(wsum, 1e-20)[:, None]

    i = np.arange(th * tw)
    v0 = (i // tw).astype(np.float64) / th
    u0 = (i % tw).astype(np.float64) / tw
    du = np.full(th * tw, 1.0 / tw)
    dv = np.full(th * tw, 1.0 / th)
    sa = (2.0 * np.pi / tw) * (np.cos(np.pi * v0) - np.cos(np.pi * (v0 + dv)))
    uv = np.stack([u0, v0, du, dv], axis=-1)
    return (rad.astype(np.float32), uv.astype(np.float32),
            sa.astype(np.float32))


FUSED_ATLAS_ROWS = 256  # texel rows of the fused atlas, all textures
FUSED_TEX_MAX_W = 128  # texels per atlas row


def _box_mip(t: np.ndarray) -> np.ndarray:
    """One 2x box-filter mip level (odd tails fold into the last bin)."""
    h, w = t.shape[0], t.shape[1]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    t = t[: h2 * 2, : w2 * 2]
    return 0.25 * (t[0::2, 0::2] + t[1::2, 0::2] + t[0::2, 1::2]
                   + t[1::2, 1::2])


def _build_fused_atlas(textures):
    """Mip-clamped texture atlas of the fused kernels: each texture is
    box-mipped until it is at most FUSED_TEX_MAX_W wide, then the tallest
    is mipped until all fit FUSED_ATLAS_ROWS rows; textures that already
    fit are stored exactly. Returns (atlas [384, rows_pad] with
    [c*128 + x, row0 + y] = texel (y, x, c), meta [T_pad, 4] with
    (row0, width, height, 1) per texture)."""
    mips = [np.asarray(t, np.float32) for t in textures]
    for i in range(len(mips)):
        while mips[i].shape[1] > FUSED_TEX_MAX_W:
            mips[i] = _box_mip(mips[i])
    while sum(m.shape[0] for m in mips) > FUSED_ATLAS_ROWS:
        i = int(np.argmax([m.shape[0] for m in mips]))
        if mips[i].shape[0] <= 1:
            break
        mips[i] = _box_mip(mips[i])

    rows = sum(m.shape[0] for m in mips)
    rows_pad = max(-(-rows // 128) * 128, 128)
    atlas = np.zeros((384, rows_pad), np.float32)
    t_pad = max(-(-len(mips) // 8) * 8, 8)
    meta = np.zeros((t_pad, 4), np.float32)
    r0 = 0
    for i, m in enumerate(mips):
        h, w = m.shape[0], m.shape[1]
        for c in range(3):
            atlas[c * 128:c * 128 + w, r0:r0 + h] = m[..., c].T
        meta[i] = (r0, w, h, 1.0)
        r0 += h
    return atlas, meta


def build_scene(
    instances: Sequence[MeshInstance],
    materials: Sequence[MaterialDesc],
    env_map: Optional[np.ndarray] = None,
    textures: Optional[Sequence[np.ndarray]] = None,
    bvh_impl: str = "auto",
) -> SceneArrays:
    """Flatten instances to world space (the JAX `build_scene` minus the
    structures the port does not read); `bvh_impl` picks the BVH builder
    (`scene.bvh.build_bvh`)."""
    all_v, all_n, all_uv, all_mid = [], [], [], []
    light_prim_ids, light_radiance, light_power = [], [], []
    prim_base = 0
    for inst in instances:
        m = build_transformation_matrix(inst.translation, inst.rotation,
                                        inst.scale)
        normal_mat = np.linalg.inv(m[:3, :3]).T
        v = np.asarray(inst.vertices, np.float32).reshape(-1, 3)
        n = np.asarray(inst.normals, np.float32).reshape(-1, 3)
        uv = np.asarray(inst.uvs, np.float32).reshape(-1, 2)
        if v.shape[0] % 3 != 0 or v.shape != n.shape:
            raise ValueError("instance vertices/normals must be [3n, 3]")
        wv = v @ m[:3, :3].T + m[:3, 3]
        wn = n @ normal_mat.T
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-20)
        n_prims = v.shape[0] // 3
        all_v.append(wv.astype(np.float32))
        all_n.append(wn.astype(np.float32))
        all_uv.append(uv.astype(np.float32))
        all_mid.append(np.full(n_prims, inst.material_id, np.int32))
        mat = materials[inst.material_id]
        if mat.type == LIGHT:
            tri = wv.reshape(-1, 3, 3)
            area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                           tri[:, 2] - tri[:, 0]),
                                  axis=-1) * 0.5
            radiance = np.asarray(mat.base_color, np.float32)
            power = _luminance_np(radiance) * TWO_PI * area
            for i in range(n_prims):
                light_prim_ids.append(prim_base + i)
                light_radiance.append(radiance)
                light_power.append(power[i])
        prim_base += n_prims

    verts = np.concatenate(all_v).reshape(-1, 3, 3)
    norms = np.concatenate(all_n).reshape(-1, 3, 3)
    uvs = np.concatenate(all_uv).reshape(-1, 3, 2)
    mat_ids = np.concatenate(all_mid)
    if verts.shape[0] == 0:
        raise ValueError("scene has no primitives")

    perm = _morton_order(verts.mean(axis=1))
    verts, norms, uvs, mat_ids = verts[perm], norms[perm], uvs[perm], mat_ids[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0])
    light_prim_ids = [int(inv_perm[i]) for i in light_prim_ids]

    if light_prim_ids:
        lp = np.asarray(light_prim_ids, np.int32)
        lr = np.asarray(light_radiance, np.float32)
    else:
        lp = np.zeros(1, np.int32)
        lr = np.zeros((1, 3), np.float32)
    lverts = verts[lp]
    le1 = lverts[:, 1] - lverts[:, 0]
    le2 = lverts[:, 2] - lverts[:, 0]
    lcross = np.cross(le1, le2)
    larea = np.linalg.norm(lcross, axis=-1) * 0.5
    lnormal = lcross / np.maximum(
        np.linalg.norm(lcross, axis=-1, keepdims=True), 1e-20)
    lcenter = lverts.mean(axis=1)
    lradius = np.linalg.norm(lverts - lcenter[:, None, :], axis=-1).max(axis=1)

    bvh = build_bvh(verts.reshape(-1, 3), impl=bvh_impl)
    # light + env alias tables (createLightSampler, scene.cpp:136-157)
    powers = list(light_power)
    if env_map is None:
        env = np.zeros((1, 1, 3), np.float32)
        env_tiles = (np.zeros((1, 3), np.float32),
                     np.zeros((1, 4), np.float32), np.zeros((1,), np.float32))
        env_table = build_alias_table(np.ones(1))
    else:
        env = np.asarray(env_map, np.float32)
        env_tiles = _build_env_tiles(env)
        row = (np.arange(env.shape[0], dtype=np.float32) + 0.5) / env.shape[0]
        env_pdf = _luminance_np(env) * np.sin(row * np.pi)[:, None]
        env_table = build_alias_table(env_pdf.reshape(-1))
        powers.append(env_table.sum_all)
    if powers:
        light_table = build_alias_table(np.asarray(powers))
        sum_power_inv = 1.0 / light_table.sum_all
    else:
        light_table = build_alias_table(np.ones(1))
        sum_power_inv = 0.0  # no lights: the pdf guards handle it
    tex_data, tex_offset, tex_width, tex_height = _pack_textures(textures)
    if textures:
        atlas, tex_meta = _build_fused_atlas(textures)
    else:
        atlas = np.zeros((384, 128), np.float32)
        tex_meta = np.zeros((8, 4), np.float32)

    def mat_arr(f, dtype):
        return np.asarray([f(m) for m in materials], dtype)

    return SceneArrays(
        verts=verts,
        norms=norms,
        uvs=uvs,
        mat_ids=mat_ids,
        bounds_lo=bvh.bounds_lo,
        bounds_hi=bvh.bounds_hi,
        bvh_prim=bvh.prim_id.reshape(-1),
        bvh_box=bvh.box_id.reshape(-1),
        bvh_miss=bvh.miss.reshape(-1),
        tri_xform=build_tri_transforms(verts.reshape(-1, 3)),
        prim_attr=build_prim_attr(verts, norms, uvs, mat_ids),
        mat_attr=build_mat_attr(materials),
        mat_type=np.asarray([m.type for m in materials], np.int32),
        light_prim_ids=lp,
        light_radiance=lr,
        light_verts=lverts,
        light_normal=lnormal.astype(np.float32),
        light_area=larea.astype(np.float32),
        light_center=lcenter.astype(np.float32),
        light_radius=lradius.astype(np.float32),
        env_map=env,
        tex_data=tex_data,
        tex_offset=tex_offset,
        tex_width=tex_width,
        tex_height=tex_height,
        env_tile_rad=env_tiles[0],
        env_tile_uv=env_tiles[1],
        env_tile_sa=env_tiles[2],
        fused_atlas=atlas,
        fused_tex_meta=tex_meta,
        light_prob=light_table.prob,
        light_alias=light_table.fail_id,
        sum_light_power_inv=np.float32(sum_power_inv),
        env_prob=env_table.prob,
        env_alias=env_table.fail_id,
        mat_base_color=mat_arr(lambda m: m.base_color, np.float32),
        mat_metallic=mat_arr(lambda m: m.metallic, np.float32),
        mat_roughness=mat_arr(lambda m: m.roughness, np.float32),
        mat_ior=mat_arr(lambda m: m.ior, np.float32),
        mat_base_map=mat_arr(lambda m: m.base_map, np.int32),
        mat_metallic_map=mat_arr(lambda m: m.metallic_map, np.int32),
        mat_roughness_map=mat_arr(lambda m: m.roughness_map, np.int32),
        mat_normal_map=mat_arr(lambda m: m.normal_map, np.int32),
    )
