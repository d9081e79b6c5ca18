"""Kernel B1: the fused resident DI kernel, and its plain PyTorch twin.

Port of `restir_tpu.ops.pallas.fused_di._di_resident_kernel`
(`di_resident_pallas`): per pixel, raygen with AA jitter, the closest
hit over the resident triangles, the G-buffer epilogue with motion
reprojection, K-candidate CDF RIS with a single-draw winner, the
winner's shadow ray and the temporal merge against the previous frame's
reuse pack. Returns the G-buffer pack gb [GB_CH, R] and the post-
temporal reuse pack pt [PT_CH, R].

`di_resident` dispatches on the device of its tensors: CPU tensors take
the plain twin `di_resident_ref`, CUDA tensors the hand-written kernel
in `csrc/fused_di.cu` (two launches: MTBVH hit + G-buffer + RIS + MTBVH
visibility on the scene's `BvhTables`, then the per-tile temporal
merge). Nothing falls back. The twin keeps the TPU kernel's
brute force over every triangle row (`closest_brute`, `occluded_brute`),
which the walks equal bit for bit.

`has_env` adds the env map (the 512 env tiles join the light CDF as
virtual lights; a miss carries the tile radiance along the ray in the
albedo slot) and `with_textures` the base / metallic / roughness / normal
maps and the procedural base colour, as the JAX kernel's flags of the
same names (`_env_tile_radiance`, `_tex_bilinear`, `_procedural_tex`).

The twin's stages (`gbuffer_pixels`, `ris_pixels`, `shadow_pixels`,
`temporal_pixels`) are also the twins of kernels B6 and B7
(`gbuffer.py`, `reuse.py`), and `temporal_cuda` launches B1b alone after
B7 on scenes over 1024 triangles.

Pack layouts are the JAX package's channel indices, as flat [C, R].
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ...utils import rng
from ...utils.math import trunc_i32 as _trunc_i32
from . import _build
from .tables import BvhTables, ResidentTables

# ---- gb pack channel layout ([GB_CH, R]) ----
G_POS = 0  # 3: world hit position (0 on miss)
G_NORM = 3  # 3: interpolated shading normal (0 on miss)
G_DIR = 6  # 3: primary ray direction
G_ALB = 9  # 3: demodulation albedo (0 on miss)
G_DEPTH = 12  # camera distance (1 on miss)
G_MOTION = 13  # last-frame linear pixel index (-1 invalid, 0 on miss)
G_PRIMR = 14  # matId | LIGHT_ID | NULL
G_MTYPE = 15
G_METAL = 16
G_ROUGH = 17
G_SHADE = 18  # valid & ~is_light
G_LIGHT = 19  # is_light
G_MISS = 20
G_PRIM = 21  # triangle id (shadow-ray self-exclusion)
G_X = 22  # raster x
G_Y = 23  # raster y
GB_CH = 24

# ---- pt (reuse) pack channel layout ([PT_CH, R]) ----
P_LI = 0  # 3
P_WI = 3  # 3
P_DIST = 6
P_WEIGHT = 7
P_M = 8
P_PRIMR = 9
P_NORM = 10  # 3
P_DEPTH = 13
PT_CH = 16

# ---- rs (candidate) pack between the two CUDA launches ([RS_CH, R]) ----
RS_LI = 0  # 3
RS_WI = 3  # 3
RS_DIST = 6
RS_W = 7  # weight after visibility
RS_CH = 8

TILE = 1024  # pixels per temporal-window tile
WINDOW = 2048  # temporal window (pixels) per tile
MAX_K = 8  # candidates the CUDA kernel supports

LAMBERTIAN, METALLIC, DIELECTRIC, LIGHT = 0.0, 1.0, 2.0, 4.0
LIGHT_ID = -2.0
NULL = -1.0
BIG = 3.0e38
PI = 3.14159265358979
INV_PI = 1.0 / PI

CTR_TEMPORAL = 0
CTR_SPATIAL = 1
CTR_RIS = 8

ENV_DIST = 1.0e8  # shadow-ray limit of an env winner (ops/lights.ENV_DIST)
ENV_TH, ENV_TW = 16, 32  # env tile grid (scene_data.ENV_TILE_H/W)
SMEM_MAX = 232448  # shared memory a block can use on Hopper (bytes)

launches = 0  # CUDA kernel launches (two per di_resident call)
temporal_launches = 0  # B1b launches through temporal_cuda (split path)

_CHUNK_ELEMS = 2 ** 25  # pixels x triangle rows per step of the plain twins


def chunk_pixels(n_rows: int) -> int:
    """Pixels per step of a brute twin over `n_rows` triangle rows: whole
    1024-pixel tiles, so its [pixels, rows] intermediates stay near 128 MB
    each."""
    return max(1, min(32768, _CHUNK_ELEMS // max(n_rows, 1)) // TILE) * TILE


def eval_bsdf_lum(mtype, metallic, roughness, n, wo, wi, has_met=True):
    """Luminance of the demodulated BSDF (base colour 1): Lambert, GGX
    metallic workflow, dielectric -> 0. `n`, `wo`, `wi` are (x, y, z)
    tuples of tensors. Mirrors `ris_kernel._eval_bsdf_lum`."""
    if not has_met:
        return torch.where(mtype == LAMBERTIAN, INV_PI, 0.0)
    nx, ny, nz = n
    wox, woy, woz = wo
    wix, wiy, wiz = wi
    cos_o = nx * wox + ny * woy + nz * woz
    cos_i = nx * wix + ny * wiy + nz * wiz
    hx, hy, hz = wox + wix, woy + wiy, woz + wiz
    hl = torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz), min=1e-20)
    hx, hy, hz = hx / hl, hy / hl, hz / hl
    alpha = roughness * roughness
    cos_h = nx * hx + ny * hy + nz * hz
    hdoto = hx * wox + hy * woy + hz * woz
    aa = alpha * alpha
    denom = cos_h * cos_h * (aa - 1.0) + 1.0
    d_ggx = torch.where(
        cos_h < 1e-6, 0.0,
        aa / torch.clamp(denom * denom * PI, min=1e-20))
    a_half = alpha * 0.5

    def schlick_g(c):
        c = torch.abs(c)
        return c / torch.clamp(c * (1.0 - a_half) + a_half, min=1e-20)

    g = schlick_g(cos_o) * schlick_g(cos_i)
    f0 = 0.08 * (1.0 - metallic) + metallic
    one_m = 1.0 - hdoto
    p5 = one_m * one_m
    p5 = p5 * p5 * one_m
    fr = f0 * (1.0 - p5) + p5
    spec = g * d_ggx / torch.clamp(4.0 * cos_i * cos_o, min=1e-20)
    diffuse = INV_PI * (1.0 - metallic)
    met = diffuse * (1.0 - fr) + spec * fr
    met = torch.where(cos_i * cos_o >= 1e-7, met, 0.0)
    return torch.where(mtype == LAMBERTIAN, INV_PI,
                       torch.where(mtype == METALLIC, met, 0.0))


def _bad(w):
    return torch.isnan(w) | torch.isinf(w) | (w < 0.0)


def check_env(env_rad, has_env: bool) -> None:
    """Env branches read 512 env-tile rows; refuse a scene without them."""
    if has_env and env_rad.shape[0] != ENV_TH * ENV_TW:
        raise ValueError("has_env_map is set but the scene has no env map")


def _pseudo_angle_const(phi: float) -> float:
    """Monotone trig-free surrogate p(phi) in [0, 4) of an azimuth
    (fused_di._pseudo_angle_const), in double."""
    ax, az = math.cos(phi), math.sin(phi)
    p = az / (abs(ax) + abs(az) + 1e-20)
    if ax < 0:
        p = 2.0 - p
    elif az < 0:
        p = 4.0 + p
    return p


# float32 tile thresholds of env_tile_radiance, computed in double (the
# same constants as kEnvCosY / kEnvAngX in csrc/di_core.cuh)
ENV_COS_Y = np.float32([math.cos(math.pi * t / ENV_TH)
                        for t in range(1, ENV_TH)])
ENV_ANG_X = np.float32([_pseudo_angle_const(2.0 * math.pi * s / ENV_TW)
                        for s in range(1, ENV_TW)])


def env_tile_radiance(env_rad, dx, dy, dz):
    """Piecewise-constant env radiance [3, b] along (dx, dy, dz): the tile
    from 15 cosine compares on dy and 31 pseudo-angle compares on
    (dx, dz) (fused_di._env_tile_radiance)."""
    cy = torch.as_tensor(ENV_COS_Y, device=dy.device)
    ax = torch.as_tensor(ENV_ANG_X, device=dy.device)
    ty = (dy[:, None] <= cy[None, :]).sum(dim=1)
    p = dz / (torch.abs(dx) + torch.abs(dz) + 1e-20)
    p = torch.where(dx < 0.0, 2.0 - p, torch.where(dz < 0.0, 4.0 + p, p))
    tx = (p[:, None] >= ax[None, :]).sum(dim=1)
    return env_rad[ty * ENV_TW + tx, 0:3].T


def _wrap(a, m):
    w = a - torch.floor(a / m) * m
    return torch.where(w >= m, 0.0, w)


def tex_bilinear(atlas, tex_meta, tid_f, u_uv, v_uv):
    """Wrap-mode bilinear fetch [3, b] of texture ids `tid_f` (float; a
    negative id reads texture 0) at (u, v) from the mip-clamped atlas
    (fused_di._tex_bilinear; image.h:41-74)."""
    n_tex = tex_meta.shape[0]
    tid = _trunc_i32(torch.clamp(tid_f, min=0.0)).to(torch.int64)
    ok = tid < n_tex
    meta = tex_meta[torch.where(ok, tid, 0)].T
    row0 = torch.where(ok, meta[0], 0.0)
    tw = torch.clamp(torch.where(ok, meta[1], 0.0), min=1.0)
    th = torch.clamp(torch.where(ok, meta[2], 0.0), min=1.0)
    u = u_uv - torch.floor(u_uv)
    v = v_uv - torch.floor(v_uv)
    fx = u * tw - 0.5
    fy = v * th - 0.5
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    lx = fx - ix
    ly = fy - iy
    x0 = _wrap(ix, tw)
    y0 = _wrap(iy, th)
    x1 = _wrap(x0 + 1.0, tw)
    y1 = _wrap(y0 + 1.0, th)

    def texel(y, x):
        row = _trunc_i32(row0 + y).to(torch.int64)
        return atlas[row * 128 + _trunc_i32(x).to(torch.int64), 0:3].T

    c00, c10 = texel(y0, x0), texel(y0, x1)
    c01, c11 = texel(y1, x0), texel(y1, x1)
    cx0 = c00 + (c10 - c00) * lx
    cx1 = c01 + (c11 - c01) * lx
    return cx0 + (cx1 - cx0) * ly


def procedural_tex(u_uv, v_uv):
    """Sine-grid procedural texture (fused_di._procedural_tex; scene.h:
    68-76): the cell index wraps as uint32, its pcg4d stream jitters the
    phase."""
    cell = (_trunc_i32(u_uv * 1024.0).to(torch.int64) * 1024
            + _trunc_i32(v_uv * 1024.0).to(torch.int64))
    h = rng.pcg4d(cell, 0, 0, rng.SALT_DEBUG)
    rx, ry = rng._unit(h[0]), rng._unit(h[1])
    two_pi = 2.0 * PI
    f = (torch.sin(u_uv * 10.0 * two_pi + rx * two_pi) + 1.0) * 0.5
    g = (torch.sin(v_uv * 10.0 * two_pi + ry * two_pi) + 1.0) * 0.5
    return f * g


def _inv_len(x, y, z):
    return 1.0 / torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-20)


def normal_map(rgb, nx, ny, nz):
    """World normal from a tangent-space normal-map texel [3, b] around
    (nx, ny, nz): local_to_world(n, normalize(texel - 0.5))."""
    vx, vy, vz = rgb[0] - 0.5, rgb[1] - 0.5, rgb[2] - 0.5
    vinv = _inv_len(vx, vy, vz)
    vx, vy, vz = vx * vinv, vy * vinv, vz * vinv
    usez = torch.abs(ny) > 0.9999  # helper axis z near the poles
    bx = torch.where(usez, ny, -nz)
    by = torch.where(usez, -nx, 0.0)
    bz = torch.where(usez, 0.0, nx)
    binv = _inv_len(bx, by, bz)
    bx, by, bz = bx * binv, by * binv, bz * binv
    tx = by * nz - bz * ny
    ty = bz * nx - bx * nz
    tz = bx * ny - by * nx
    rx = tx * vx + bx * vy + nx * vz
    ry = ty * vx + by * vy + ny * vz
    rz = tz * vx + bz * vy + nz * vz
    rinv = _inv_len(rx, ry, rz)
    return rx * rinv, ry * rinv, rz * rinv


def _hit_loop(planes, o, d):
    """Ray-plane products [b, n_pad] of rays (o, d) against every
    unit-triangle plane row: (oo.u, oo.v, oo.w, dd.u, dd.v, dd.w)."""
    xp = planes  # [n_pad, 12]
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)

    def row(c):
        return xp[:, c][None, :]

    oou = row(0) * ox + row(1) * oy + row(2) * oz + row(3)
    oov = row(4) * ox + row(5) * oy + row(6) * oz + row(7)
    oow = row(8) * ox + row(9) * oy + row(10) * oz + row(11)
    ddu = row(0) * dx + row(1) * dy + row(2) * dz
    ddv = row(4) * dx + row(5) * dy + row(6) * dz
    ddw = row(8) * dx + row(9) * dy + row(10) * dz
    return oou, oov, oow, ddu, ddv, ddw


def closest_brute(planes, o, d):
    """Closest hit over every plane row: (dist, prim, u, v), ties to the
    lowest triangle index (argmin takes the first), BIG / -1 / 0 / 0 on a
    miss."""
    oou, oov, oow, ddu, ddv, ddw = _hit_loop(planes, o, d)
    nondeg = torch.abs(ddw) >= 1e-12
    t = -oow / torch.where(nondeg, ddw, 1.0)
    u = oou + t * ddu
    v = oov + t * ddv
    hit = nondeg & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    dist = torch.where(hit, t, BIG)
    j = torch.argmin(dist, dim=1)
    d_best = torch.gather(dist, 1, j[:, None])[:, 0]
    u_best = torch.gather(u, 1, j[:, None])[:, 0]
    v_best = torch.gather(v, 1, j[:, None])[:, 0]
    hit_any = d_best < BIG
    prim = torch.where(hit_any, j.to(torch.int32), -1)
    u_best = torch.where(hit_any, u_best, 0.0)
    v_best = torch.where(hit_any, v_best, 0.0)
    return d_best, prim, u_best, v_best


def occluded_brute(planes, o, d, limit, prim_o):
    """Any hit at 0 < t < limit on a row other than prim_o."""
    oou, oov, oow, ddu, ddv, ddw = _hit_loop(planes, o, d)
    nondeg = torch.abs(ddw) >= 1e-12
    tt = -oow / torch.where(nondeg, ddw, 1.0)
    uu = oou + tt * ddu
    vv = oov + tt * ddv
    ids = torch.arange(planes.shape[0], device=planes.device,
                       dtype=torch.int32)[None, :]
    blocked = (nondeg & (tt > 0.0) & (uu >= 0.0) & (vv >= 0.0)
               & (uu + vv <= 1.0) & (tt < limit[:, None])
               & (ids != prim_o[:, None]))
    return blocked.any(dim=1)


def gbuffer_pixels(pix, cam, lcam, looper, tables, *, width, height,
                   aa_jitter, single_sided, has_env=False,
                   with_textures=False):
    """Raygen + brute closest hit + G-buffer epilogue for pixels `pix`
    (int64): gb columns [GB_CH, len(pix)]. The plain twin of B1's first
    stage and of kernel B6. `tables` holds planes, attr, mat, env_rad,
    atlas and tex_meta (ResidentTables or BvhTables)."""
    b = pix.shape[0]
    x = (pix % width).to(torch.float32)
    y = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    if aa_jitter:
        rx, ry = rng.uniform2(pix, looper, 0, rng.SALT_CAMERA)
    else:
        rx = torch.full((b,), 0.5, device=pix.device)
        ry = rx
    aspect = float(width) / float(height)
    tanf, focal = cam[12], cam[13]
    ruv_x = 1.0 - 2.0 * (x + rx) * (1.0 / width)
    ruv_y = 1.0 - 2.0 * (y + ry) * (1.0 / height)
    fx = ruv_x * (aspect * tanf * focal)
    fy = ruv_y * (tanf * focal)
    dx = cam[3] * fx + cam[6] * fy + cam[9] * focal
    dy = cam[4] * fx + cam[7] * fy + cam[10] * focal
    dz = cam[5] * fx + cam[8] * fy + cam[11] * focal
    dinv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * dinv, dy * dinv, dz * dinv
    ox = cam[0].expand(b)
    oy = cam[1].expand(b)
    oz = cam[2].expand(b)

    best_dist, best_prim, u, v = closest_brute(tables.planes, (ox, oy, oz),
                                          (dx, dy, dz))
    valid0 = best_dist < BIG
    at = torch.where(valid0[:, None],
                     tables.attr[torch.clamp(best_prim, min=0).long()], 0.0)
    at = at.T  # [32, b]
    pxp = at[0] + u * at[3] + v * at[6]
    pyp = at[1] + u * at[4] + v * at[7]
    pzp = at[2] + u * at[5] + v * at[8]
    nxp = at[9] + u * at[12] + v * at[15]
    nyp = at[10] + u * at[13] + v * at[16]
    nzp = at[11] + u * at[14] + v * at[17]
    nlen = torch.rsqrt(torch.clamp(nxp * nxp + nyp * nyp + nzp * nzp,
                                   min=1e-20))
    nxp, nyp, nzp = nxp * nlen, nyp * nlen, nzp * nlen
    mat_id_f = at[24]
    matp = tables.mat[mat_id_f.to(torch.int64)].T  # [16, b]

    metallic, roughness = matp[4], matp[5]
    if with_textures:
        # metallic / roughness / normal maps (scene.h:86-97), before the
        # front-face test reads the normal
        u_uv = at[18] + u * at[20] + v * at[22]
        v_uv = at[19] + u * at[21] + v * at[23]

        def fetch(tid_f):
            return tex_bilinear(tables.atlas, tables.tex_meta, tid_f, u_uv,
                                v_uv)

        use = valid0 & (matp[8] > -0.5)
        metallic = torch.where(use, fetch(matp[8])[0], metallic)
        use = valid0 & (matp[9] > -0.5)
        roughness = torch.where(use, fetch(matp[9])[0], roughness)
        use = valid0 & (matp[10] > -0.5)
        nm = normal_map(fetch(matp[10]), nxp, nyp, nzp)
        nxp, nyp, nzp = (torch.where(use, a, b)
                         for a, b in zip(nm, (nxp, nyp, nzp)))

    mtype = matp[0]
    is_light = valid0 & (mtype == LIGHT)
    front = (nxp * dx + nyp * dy + nzp * dz) < 0.0
    valid = valid0 & ~(is_light & ~front) if single_sided else valid0
    is_light = is_light & valid
    shade = valid & ~is_light
    prim_remap = torch.where(valid, torch.where(is_light, LIGHT_ID, mat_id_f),
                             NULL)

    px = torch.where(valid, pxp, 0.0)
    py = torch.where(valid, pyp, 0.0)
    pz = torch.where(valid, pzp, 0.0)
    tox, toy, toz = px - ox, py - oy, pz - oz
    depth = torch.where(valid, torch.sqrt(tox * tox + toy * toy + toz * toz),
                        1.0)

    lx, ly, lz = px - lcam[0], py - lcam[1], pz - lcam[2]
    linv = torch.rsqrt(torch.clamp(lx * lx + ly * ly + lz * lz, min=1e-20))
    lx, ly, lz = lx * linv, ly * linv, lz * linv
    ldep = lx * lcam[9] + ly * lcam[10] + lz * lcam[11]
    ldep_inv = 1.0 / torch.where(torch.abs(ldep) < 1e-20, 1e-20, ldep)
    prx = (lx * lcam[3] + ly * lcam[4] + lz * lcam[5]) * ldep_inv
    pry = (lx * lcam[6] + ly * lcam[7] + lz * lcam[8]) * ldep_inv
    ltan = lcam[12]
    un = (-(prx / (aspect * ltan))) * 0.5 + 0.5
    vn = (-(pry / ltan)) * 0.5 + 0.5
    mx = _trunc_i32(un * width)
    my = _trunc_i32(vn * height)
    in_b = (mx >= 0) & (mx < width) & (my >= 0) & (my < height)
    motion = torch.where(
        valid, torch.where(in_b, (my * width + mx).to(torch.float32), NULL),
        0.0)

    base = matp[1:4]
    if with_textures:
        tid = matp[7]  # base map: -1 none, -2 procedural
        base = torch.where(
            (tid > -0.5)[None], fetch(tid),
            torch.where(((tid > -2.5) & (tid < -1.5))[None],
                        procedural_tex(u_uv, v_uv)[None], base))
    miss_alb = (env_tile_radiance(tables.env_rad, dx, dy, dz) if has_env
                else torch.zeros_like(base))
    alb = torch.where(valid[None], base, miss_alb)
    chans = [
        px, py, pz,
        torch.where(valid, nxp, 0.0), torch.where(valid, nyp, 0.0),
        torch.where(valid, nzp, 0.0),
        dx, dy, dz,
        alb[0], alb[1], alb[2],
        depth, motion, prim_remap, mtype, metallic, roughness,
        shade.to(torch.float32), is_light.to(torch.float32),
        (~valid).to(torch.float32),
        torch.where(valid, best_prim.to(torch.float32), NULL),
        x, y,
    ]
    return torch.stack(chans)


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in
    float64), on either device."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def ris_frame(gb):
    """The shading frame the light targets read, as csrc/di_core.cuh's
    `ris_frame` computes it: the normal facing wo (dielectrics keep
    theirs), n.p, |p|^2 and p."""
    px, py, pz = gb[G_POS], gb[G_POS + 1], gb[G_POS + 2]
    nx, ny, nz = gb[G_NORM], gb[G_NORM + 1], gb[G_NORM + 2]
    dx, dy, dz = gb[G_DIR], gb[G_DIR + 1], gb[G_DIR + 2]
    ndotwo = _fma32(nz, -dz, _fma32(nx, -dx, ny * -dy))
    flip = (gb[G_MTYPE] != DIELECTRIC) & (ndotwo < 0.0)
    nx, ny, nz = (torch.where(flip, -c, c) for c in (nx, ny, nz))
    ndx = _fma32(nz, pz, _fma32(ny, py, nx * px))
    x2 = _fma32(pz, pz, _fma32(px, px, py * py))
    return dict(n=(nx, ny, nz), p=(px, py, pz), ndx=ndx, x2=x2)


def light_target_rows(psi, f, single_sided):
    """Light targets [b, rows] of psi rows at frame f: csrc/di_core.cuh's
    `light_target` (`light_target4`), with its products fused into FMAs
    where the CUDA builds fuse them."""
    nx, ny, nz = (c[:, None] for c in f["n"])
    px, py, pz = (c[:, None] for c in f["p"])
    ndx, x2 = f["ndx"][:, None], f["x2"][:, None]
    q = [psi[:, c][None] for c in range(15)]
    a = _fma32(q[3], -ndx, _fma32(q[2], nz, _fma32(q[0], nx, q[1] * ny)))
    bb = _fma32(q[6], pz, _fma32(q[4], px, q[5] * py)) + q[7]
    d2 = _fma32(q[12], x2, _fma32(q[10], -2.0 * pz, _fma32(
        q[8], -2.0 * px, q[9] * (-2.0 * py))) + q[11])
    d2 = torch.clamp(d2, min=1e-8)
    side = bb > 0.0 if single_sided else torch.abs(bb) > 0.0
    rad = q[14]
    above = (a + rad) > 0.0
    a_eff = torch.maximum(a, 0.1 * rad)
    return torch.where(above & side,
                       q[13] * a_eff * torch.abs(bb) / (d2 * d2), 0.0)


def ris_targets(gb, psi, single_sided):
    """The RIS core's shading normal (flipped to face wo unless
    dielectric) and the light target of every psi row [b, l_pad] at the gb
    columns' shading points (fused_di._ris_select_core's three psi
    products), rounded as the kernels round them (`ris_frame`,
    `light_target_rows`): with thousands of lights, a target left
    unfused moves the sum of the near ones by more than the gates'
    rtol."""
    f = ris_frame(gb)
    return f["n"], light_target_rows(psi, f, single_sided)


def cdf_rows(t):
    """Running sums of t [b, l] along l, one float32 add a row in row
    order: the kernels' scan (torch.cumsum adds in another order on the
    card, and in float64 on the CPU). Each step adds one contiguous row
    of the transposed sums; callers pass wide batches (`ris_all`)."""
    out = t.T.contiguous()
    for l in range(1, out.shape[0]):
        torch.add(out[l - 1], out[l], out=out[l])
    return out.T


def ris_all(gb, pix, looper, tables, *, has_env=False, **kw):
    """`ris_pixels` over every column of gb, in chunks as wide as its
    [pixels, light rows] intermediates allow (`chunk_pixels` of the light
    rows): the row-order CDF (`cdf_rows`) then loops once a chunk, not
    once a brute twin's narrower chunk over triangle rows."""
    chunk = chunk_pixels(tables.light_rows(has_env)[1].shape[0])
    parts = [ris_pixels(gb[:, p0:p0 + chunk], pix[p0:p0 + chunk], looper,
                        tables, has_env=has_env, **kw)
             for p0 in range(0, pix.shape[0], chunk)]
    return tuple(torch.cat(xs, dim=-1) for xs in zip(*parts))


def ris_pixels(gb, pix, looper, tables, *, k, single_sided, has_met,
               has_env=False):
    """K-candidate CDF RIS + single-draw winner for the gb columns of
    pixels `pix` -> (li [3, b], wi [3, b], dist [b], W [b]). With
    `has_env` the CDF runs over the area lights and the env tiles."""
    lights, psi = tables.light_rows(has_env)
    l_pad = psi.shape[0]
    px, py, pz = gb[G_POS], gb[G_POS + 1], gb[G_POS + 2]
    wox, woy, woz = -gb[G_DIR], -gb[G_DIR + 1], -gb[G_DIR + 2]
    mtype, metallic, roughness = gb[G_MTYPE], gb[G_METAL], gb[G_ROUGH]
    shade = gb[G_SHADE] > 0.5
    (nx, ny, nz), t = ris_targets(gb, psi, single_sided)
    cdf = cdf_rows(t)
    total = cdf[:, l_pad - 1]

    w_list, li_list, wi_list, dist_list = [], [], [], []
    r4_0 = None
    for j in range(k):
        r1, r2, r3, r4 = rng.uniform4(pix, looper, CTR_RIS + j,
                                      rng.SALT_RESTIR)
        if j == 0:
            r4_0 = r4
        thresh = r1 * total
        idx = torch.clamp((cdf <= thresh[:, None]).sum(dim=1), max=l_pad - 1)
        t_pick = torch.gather(t, 1, idx[:, None])[:, 0]
        q = t_pick / torch.clamp(total, min=1e-20)
        lrow = lights[idx].T  # [16, b]
        sr = torch.sqrt(torch.clamp(r3, min=0.0))
        bu = 1.0 - sr
        bv = r2 * sr
        sx = lrow[0] + bu * lrow[3] + bv * lrow[6]
        sy = lrow[1] + bu * lrow[4] + bv * lrow[7]
        sz = lrow[2] + bu * lrow[5] + bv * lrow[8]
        tox, toy, toz = sx - px, sy - py, sz - pz
        dist2 = torch.clamp(tox * tox + toy * toy + toz * toz, min=1e-20)
        inv_dist = torch.rsqrt(dist2)
        dist = dist2 * inv_dist
        wix, wiy, wiz = tox * inv_dist, toy * inv_dist, toz * inv_dist
        cos_l = lrow[9] * wix + lrow[10] * wiy + lrow[11] * wiz
        pdf = q * dist2 / torch.clamp(lrow[15] * torch.abs(cos_l), min=1e-20)
        if single_sided:
            pdf = torch.where(cos_l <= -1e-6, pdf, -1.0)
        pdf = torch.where((total > 0.0) & (q > 0.0), pdf, -1.0)
        if has_env:
            # env tile rows (u0, v0 | du | dv): uv-uniform point, to_sphere
            env_m = idx >= tables.n_lights
            phi = (lrow[0] + r2 * lrow[3]) * (2.0 * PI)
            th = (lrow[1] + r3 * lrow[6]) * PI
            st = torch.sin(th)
            pdf_env = q / torch.clamp(
                lrow[3] * lrow[6] * (2.0 * PI * PI)
                * torch.clamp(st, min=1e-6), min=1e-20)
            pdf_env = torch.where((total > 0.0) & (q > 0.0), pdf_env, -1.0)
            pdf = torch.where(env_m, pdf_env, pdf)
            wix = torch.where(env_m, torch.cos(phi) * st, wix)
            wiy = torch.where(env_m, torch.cos(th), wiy)
            wiz = torch.where(env_m, torch.sin(phi) * st, wiz)
            dist = torch.where(env_m, ENV_DIST, dist)
        f_lum = eval_bsdf_lum(mtype, metallic, roughness, (nx, ny, nz),
                              (wox, woy, woz), (wix, wiy, wiz), has_met)
        li_lum = 0.2126 * lrow[12] + 0.7152 * lrow[13] + 0.0722 * lrow[14]
        cos_s = torch.clamp(nx * wix + ny * wiy + nz * wiz, min=0.0)
        p_hat = li_lum * f_lum * cos_s
        w = p_hat / pdf
        bad = torch.isnan(w) | torch.isinf(w) | (pdf <= 0.0)
        w = torch.where(bad | ~shade, 0.0, w)
        w_list.append(w)
        li_list.append(lrow[12:15])
        wi_list.append(torch.stack([wix, wiy, wiz]))
        dist_list.append(dist)

    c = w_list[0]
    cums = []
    for j in range(1, k):
        cums.append(c)
        c = c + w_list[j]
    r_weight = c
    thresh_sel = r4_0 * r_weight
    jsel = torch.zeros_like(r_weight, dtype=torch.int64)
    for cj in cums:
        jsel = jsel + (cj <= thresh_sel).to(torch.int64)
    gate = (r_weight > 0.0) & shade
    li = torch.stack(li_list)  # [k, 3, b]
    wi = torch.stack(wi_list)
    dist = torch.stack(dist_list)  # [k, b]
    sel = jsel[None, None, :].expand(1, 3, -1)
    li_w = torch.gather(li, 0, sel)[0]
    wi_w = torch.gather(wi, 0, sel)[0]
    dist_w = torch.gather(dist, 0, jsel[None, :])[0]
    li_w = torch.where(gate[None], li_w, 0.0)
    wi_w = torch.where(gate[None], wi_w, 0.0)
    dist_w = torch.where(gate, dist_w, 0.0)
    return li_w, wi_w, dist_w, r_weight


def _window_start(gb_tile_motion, gb_tile_miss, r_prev, window=WINDOW):
    """Per-1024-pixel-tile temporal window start (fused_di._window_start):
    min valid motion, rounded down to 128, clamped to [0, r_prev -
    window] (r_prev: the previous pack's pixels)."""
    valid = (gb_tile_motion >= 0.0) & ~(gb_tile_miss > 0.5)
    m_valid = torch.where(valid, gb_tile_motion, float(r_prev))
    w0 = m_valid.min(dim=1).values.to(torch.int64)
    w0 = torch.div(w0, 128, rounding_mode="floor") * 128
    return torch.clamp(w0, 0, max(r_prev - window, 0))


def band_pixels(width, height, pix0=0, r=None):
    """(pix0, r) of a band of the width x height frame, checked: r
    defaults to the rest of the frame; the band must lie inside it."""
    total = width * height
    if r is None:
        r = total - pix0
    if pix0 < 0 or r <= 0 or pix0 + r > total:
        raise ValueError(f"band [{pix0}, {pix0 + r}) outside the "
                         f"{width}x{height} frame")
    return pix0, r


def check_window(window: int) -> None:
    """The temporal window is whole 1024-pixel tiles (the guard that
    `reuse_pallas` lacks: its mod-gather chunks the window 8 ways)."""
    if window <= 0 or window % TILE:
        raise ValueError(f"temporal window {window} is not a positive "
                         f"multiple of {TILE}")


def rebase_motion(motion, prev_base: int):
    """Motion indices relative to the previous pack's first global pixel
    `prev_base` (a row band's haloed pack starts a window before the
    band); negative markers stay (fused_di.reuse_pallas's rebase)."""
    if prev_base == 0:
        return motion
    return torch.where(motion >= 0.0, motion - float(prev_base), motion)


def shadow_pixels(gb, wi, dist, r_weight, planes):
    """The winner's shadow ray by brute force over every plane row (B1's
    visibility, fused_di._vis_resident_core): W zeroed where occluded."""
    o = tuple(gb[G_POS + c] + wi[c] * 1e-5 for c in range(3))
    limit = dist * (1.0 - 1e-3) - 1e-4
    occ = occluded_brute(planes, o, tuple(wi), limit,
                         gb[G_PRIM].to(torch.int32))
    return torch.where(occ, 0.0, r_weight)


def temporal_pixels(gb, rs_li, rs_wi, rs_dist, r_weight, pix, looper, prev,
                    *, k, temporal, temporal_clamp, prev_base=0,
                    window=WINDOW):
    """Temporal merge (restir.cu:180-185) + pt-pack assembly for the
    global pixels `pix`, which must be whole 1024-pixel tiles in order
    (each tile's window start is the minimum over its own motion). `prev`
    holds the previous pack's pixels from global pixel `prev_base` (the
    whole frame, or a row band with +-window halos)."""
    shade = gb[G_SHADE] > 0.5
    r_m = torch.where(shade, float(k), 0.0)
    li, wi, dist = rs_li, rs_wi, rs_dist
    if temporal:
        check_window(window)
        r_prev = prev.shape[1]
        mo = rebase_motion(gb[G_MOTION], prev_base)
        w0 = _window_start(mo.view(-1, TILE), gb[G_MISS].view(-1, TILE),
                           r_prev, window)
        w0 = w0.repeat_interleave(TILE)
        motion = _trunc_i32(mo).to(torch.int64)
        rel = motion - w0
        in_win = ((motion >= 0) & (rel >= 0) & (rel < window)
                  & (motion < r_prev))
        gidx = torch.where(in_win, motion, w0)
        nb = prev[:, gidx]  # [PT_CH, b]
        n_weight = nb[P_WEIGHT]
        n_m = nb[P_M]
        g_nx, g_ny, g_nz = gb[G_NORM], gb[G_NORM + 1], gb[G_NORM + 2]
        depth = gb[G_DEPTH]
        prim_remap = gb[G_PRIMR]
        ok = in_win & (prim_remap > NULL) & (nb[P_PRIMR] == prim_remap)
        ok = ok & (torch.abs(g_nx * nb[P_NORM] + g_ny * nb[P_NORM + 1]
                             + g_nz * nb[P_NORM + 2]) >= 0.9)
        ok = ok & (torch.abs(nb[P_DEPTH] - depth) <= depth * 0.1)
        ok = ok & shade & ~_bad(n_weight)

        cap = float(temporal_clamp)
        limit_m = torch.where(r_m > 0.0, (cap - 1.0) * r_m, n_m)
        over = n_m > limit_m
        scale = limit_m / torch.clamp(n_m, min=1.0)
        n_weight = torch.where(over, n_weight * scale, n_weight)
        n_m = torch.where(over, limit_m, n_m)

        r_t = rng.uniform1(pix, looper, CTR_TEMPORAL, rng.SALT_RESTIR)
        w_new = torch.where(ok, r_weight + n_weight, r_weight)
        m_new = torch.where(ok, r_m + n_m, r_m)
        take = ok & (r_t * w_new < n_weight)
        li = torch.where(take[None], nb[P_LI:P_LI + 3], li)
        wi = torch.where(take[None], nb[P_WI:P_WI + 3], wi)
        dist = torch.where(take, nb[P_DIST], dist)
        r_weight, r_m = w_new, m_new

    bad = _bad(r_weight)
    r_weight = torch.where(bad, 0.0, r_weight)
    r_m = torch.where(bad, 0.0, r_m)
    zero = torch.zeros_like(r_weight)
    return torch.cat([
        li, wi, dist[None], r_weight[None], r_m[None], gb[G_PRIMR][None],
        gb[G_NORM:G_NORM + 3], gb[G_DEPTH][None], zero[None], zero[None],
    ])


def di_resident_ref(cam_vec, lcam_vec, looper, prev_pt, tables, *, width,
                    height, aa_jitter=True, single_sided=True, k=4,
                    temporal=True, temporal_clamp=20, has_met=True,
                    has_env=False, with_textures=False):
    """Plain PyTorch twin of the fused resident DI kernel."""
    check_env(tables.env_rad, has_env)
    r = width * height
    dev = prev_pt.device
    gb_out = torch.empty((GB_CH, r), dtype=torch.float32, device=dev)
    pt_out = torch.empty((PT_CH, r), dtype=torch.float32, device=dev)
    chunk = chunk_pixels(tables.planes.shape[0])
    pix = torch.arange(r, device=dev, dtype=torch.int64)
    for p0 in range(0, r, chunk):
        gb_out[:, p0:p0 + chunk] = gbuffer_pixels(
            pix[p0:p0 + chunk], cam_vec, lcam_vec, looper, tables,
            width=width, height=height, aa_jitter=aa_jitter,
            single_sided=single_sided, has_env=has_env,
            with_textures=with_textures)
    li, wi, dist, w = ris_all(gb_out, pix, looper, tables, k=k,
                              single_sided=single_sided, has_met=has_met,
                              has_env=has_env)
    for p0 in range(0, r, chunk):
        sl = slice(p0, p0 + chunk)
        gb = gb_out[:, sl]
        w_s = shadow_pixels(gb, wi[:, sl], dist[sl], w[sl], tables.planes)
        pt_out[:, sl] = temporal_pixels(gb, li[:, sl], wi[:, sl], dist[sl],
                                        w_s, pix[sl], looper, prev_pt, k=k,
                                        temporal=temporal,
                                        temporal_clamp=temporal_clamp)
    return gb_out, pt_out


def _check(t: torch.Tensor, name: str, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gbuffer_ris_cuda(cam_vec, lcam_vec, looper, tables, bvh, *, width,
                     height, aa_jitter=True, single_sided=True, k=4,
                     has_met=True, has_env=False, with_textures=False):
    """Launch B1a (`di_gbuffer_ris_kernel`): raygen, the closest hit by
    a walk of the MTBVH `bvh`, the G-buffer, RIS and the winner's MTBVH
    any hit on the resident scene's tables -> (gb [GB_CH, R], rs
    [RS_CH, R])."""
    global launches
    r = width * height
    dev = cam_vec.device
    if r % TILE != 0:
        raise ValueError(f"pixel count {r} is not a multiple of {TILE}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    lights, psi = tables.light_rows(has_env)  # raises without an env map
    l_pad = psi.shape[0]
    smem = l_pad * 32 * 4  # the light and psi rows
    if smem > SMEM_MAX:
        raise ValueError(
            f"B1 holds {l_pad} light rows in shared memory: {smem} bytes, "
            f"over the {SMEM_MAX} a block can use")
    _check(cam_vec, "cam_vec", (16,), dev)
    _check(lcam_vec, "lcam_vec", (16,), dev)
    for name in ("planes", "attr", "mat", "env_rad", "atlas", "tex_meta"):
        t = getattr(tables, name)
        _check(t, name, t.shape, dev)
    _check(bvh.rows, "rows", (6 * bvh.size, 8), dev)
    _check(lights, "lights", psi.shape, dev)
    _check(psi, "psi", psi.shape, dev)
    gb = torch.empty((GB_CH, r), dtype=torch.float32, device=dev)
    rs = torch.empty((RS_CH, r), dtype=torch.float32, device=dev)
    p = _build.ptr
    lib = _build.library()
    with _build.on_device(dev):
        err = lib.restir_di_resident_gbuffer_ris(
            p(cam_vec), p(lcam_vec), ctypes.c_uint32(looper & 0xFFFFFFFF),
            p(bvh.rows), bvh.size, p(tables.planes),
            p(tables.attr), p(tables.mat), tables.mat.shape[0], p(lights),
            p(psi), l_pad, tables.n_lights, p(tables.env_rad), p(tables.atlas),
            p(tables.tex_meta), tables.tex_meta.shape[0], int(has_env),
            int(with_textures), p(gb), p(rs), width, height,
            ctypes.c_float(float(width) / float(height)), int(aa_jitter),
            int(single_sided), k, int(has_met), _build.stream_of(dev))
    _build.check(err, "restir_di_resident_gbuffer_ris")
    launches += 1
    return gb, rs


def di_resident_cuda(cam_vec, lcam_vec, looper, prev_pt, tables, bvh, *,
                     width, height, aa_jitter=True, single_sided=True, k=4,
                     temporal=True, temporal_clamp=20, has_met=True,
                     has_env=False, with_textures=False):
    """Launch the two B1 kernels of `csrc/fused_di.cu`."""
    global launches
    _check(prev_pt, "prev_pt", (PT_CH, width * height), cam_vec.device)
    gb, rs = gbuffer_ris_cuda(
        cam_vec, lcam_vec, looper, tables, bvh, width=width, height=height,
        aa_jitter=aa_jitter, single_sided=single_sided, k=k,
        has_met=has_met, has_env=has_env, with_textures=with_textures)
    pt = _launch_temporal(gb, rs, prev_pt, looper, k, temporal,
                          temporal_clamp)
    launches += 1
    return gb, pt


def _launch_temporal(gb, rs, prev_pt, looper, k, temporal, temporal_clamp,
                     pix0=0, prev_base=0, window=WINDOW):
    """B1b (`di_temporal_kernel`) on checked packs -> pt [PT_CH, r]."""
    r = gb.shape[1]
    pt = torch.empty((PT_CH, r), dtype=torch.float32, device=gb.device)
    p = _build.ptr
    lib = _build.library()
    with _build.on_device(gb.device):
        err = lib.restir_di_resident_temporal(
            p(gb), p(rs), p(prev_pt), p(pt), r, prev_pt.shape[1], pix0,
            prev_base, window, ctypes.c_uint32(looper & 0xFFFFFFFF), k,
            int(temporal), ctypes.c_float(float(temporal_clamp)),
            _build.stream_of(gb.device))
    _build.check(err, "restir_di_resident_temporal")
    return pt


def temporal_cuda(gb, rs, prev_pt, looper, *, k=4, temporal=True,
                  temporal_clamp=20, pix0=0, prev_base=0, window=WINDOW):
    """Launch B1b (`di_temporal_kernel`) alone: merge the candidate pack
    rs [RS_CH, r] with the previous frame's pt pack. The large-scene path
    runs it after kernel B7. A row band passes its first global pixel
    `pix0`, its previous pack with +-`window` halos ([PT_CH, r + 2 x
    window]) and that pack's first global pixel `prev_base`; a whole
    frame passes its own previous pack ([PT_CH, R])."""
    global temporal_launches
    r = gb.shape[1]
    dev = gb.device
    if r % TILE != 0:
        raise ValueError(f"pixel count {r} is not a multiple of {TILE}")
    check_window(window)
    if pix0 < 0:
        raise ValueError(f"pix0 {pix0} < 0")
    _check(gb, "gb", (GB_CH, r), dev)
    _check(rs, "rs", (RS_CH, r), dev)
    _check(prev_pt, "prev_pt", (PT_CH, prev_pt.shape[1]), dev)
    pt = _launch_temporal(gb, rs, prev_pt, looper, k, temporal,
                          temporal_clamp, pix0, prev_base, window)
    temporal_launches += 1
    return pt


def di_resident(cam_vec, lcam_vec, looper, prev_pt, tables: ResidentTables,
                bvh: BvhTables, *, width, height, aa_jitter=True,
                single_sided=True, k=4, temporal=True, temporal_clamp=20,
                has_met=True, has_env=False, with_textures=False):
    """(gb [GB_CH, R], pt [PT_CH, R]) for one frame of a resident scene
    with the scene's tables and MTBVH (`scene.tables`, `scene.bvh`).

    CPU tensors take the plain twin (brute force; it reads no MTBVH),
    CUDA tensors the kernel."""
    kw = dict(width=width, height=height, aa_jitter=aa_jitter,
              single_sided=single_sided, k=k, temporal=temporal,
              temporal_clamp=temporal_clamp, has_met=has_met,
              has_env=has_env, with_textures=with_textures)
    if prev_pt.device.type == "cpu":
        return di_resident_ref(cam_vec, lcam_vec, looper, prev_pt, tables,
                               **kw)
    if prev_pt.device.type == "cuda":
        return di_resident_cuda(cam_vec, lcam_vec, looper, prev_pt, tables,
                                bvh, **kw)
    raise ValueError(f"unsupported device {prev_pt.device}")
