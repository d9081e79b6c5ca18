"""ReSTIR DI on the general path, as `restir_tpu.models.restir_di`
(restir.cu:111-231):

  1. RIS: "cdf" mode draws K = cdf_candidates samples from the exact
     per-pixel light CDF with a single-draw winner; "reference" mode
     streams K = ris_candidates power-proportional candidates
     (restir.cu:156-169);
  2. the winner's shadow ray; occluded lanes get weight 0
     (restir.cu:172-176);
  3. temporal reuse: last frame's post-temporal reservoir at the motion
     index, similarity rejection, preClampedMerge (restir.cu:180-185);
  4. spatial reuse from the post-temporal buffer, with per-frame shared
     disk offsets (the JAX package's documented deviation);
  5. shading Li / lum(Li) * W / M, modulated by the G-buffer albedo.

A row band (`restir_tpu_torch.parallel`) runs the frame in two stages:
`direct_temporal` (steps 1-3) on its pixels, with every draw keyed by
the global pixel index and the temporal gather reading the previous
frame's fields from wherever the motion points (`prev`, a fetched range
of them); then `direct_shade` (steps 4-5) on the rows of post-temporal
reservoirs the spatial taps reach around the band. `restir_direct` is
the two on the whole frame.

On CUDA tensors without an env map, cdf mode's steps 1 and 2 are kernel
B10 (`ops.kernels.ris_cdf`) with any intersector and at any triangle
count, as the JAX package runs its Pallas `ris_kernel` (which casts its
own shadow ray) on the TPU whatever `intersector` says: B10's MTBVH walk
returns the brute force's hit. Otherwise `sample_light_cdf` then
`test_occlusion`, whose intersector follows `cfg.intersector` (B11, or
B13's MTBVH walk; their twins on CPU tensors), as reference mode's
shadow ray does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig, ReuseMode
from ..ops import bsdf as bsdf_ops
from ..ops import intersect as ix
from ..ops import lights as light_ops
from ..ops import reservoir as rsv
from ..ops.kernels import ris_cdf as ris_kernel
from ..scene.mesh import DIELECTRIC
from ..utils import math as mathx
from ..utils import rng
from .gbuffer import LIGHT_ID, NULL_PRIMITIVE, GBufferFrame

# rng counter slots within SALT_RESTIR (one uniform4 each)
_CTR_TEMPORAL = 0
_CTR_SPATIAL = 1  # .. 1 + spatial_neighbors
_CTR_RIS = 8  # .. 8 + 2 K
_RIS_CHUNK = 32768  # rays per step of the cdf route's [chunk, L] matrices


def _p_hat_direct(sample: rsv.DirectSample, mat, norm, wo):
    """Target p_hat = Li f cos (restir.cu:102-105) on the demodulated
    material."""
    f = bsdf_ops.eval_bsdf(mat, norm, wo, sample.wi)
    return sample.li * f * mathx.sat_dot(norm, sample.wi)[..., None]


def temporal_pack(res_in, last_gb: GBufferFrame) -> torch.Tensor:
    """The [C, R] channel pack `find_temporal_neighbor` gathers from: the
    previous reservoir and the previous G-buffer's prim, normal, depth."""
    return rsv.pack_channels((res_in, last_gb.prim_id, last_gb.norm,
                              last_gb.depth))


def motion_valid(gb: GBufferFrame) -> torch.Tensor:
    """Lanes whose motion index a temporal gather may use: a previous
    pixel and a primitive (the range a row band fetches)."""
    return (gb.motion >= 0) & (gb.prim_id > NULL_PRIMITIVE)


def find_temporal_neighbor(res_in, gb: GBufferFrame, last_gb: GBufferFrame,
                           prev=None, prev_base: int = 0):
    """Last frame's reservoir at the motion index, with geometric
    rejection — findTemporalNeighbor (restir.cu:21-45). Returns
    (neighbour reservoir, ok mask). `prev` is `temporal_pack`'s columns
    of global pixels prev_base .. (default: the whole of `res_in` and
    `last_gb`, which otherwise give only the layout)."""
    ok = motion_valid(gb)
    template = (res_in, last_gb.prim_id, last_gb.norm, last_gb.depth)
    if prev is None:
        prev = rsv.pack_channels(template)
    rows = rsv.take_columns(prev, gb.motion, prev_base)
    neighbor, lprim, lnorm, ldepth = rsv.unpack_channels(rows, template)
    ok = (ok & (lprim == gb.prim_id)
          & (mathx.abs_dot(gb.norm, lnorm) >= 0.9)
          & (torch.abs(ldepth - gb.depth) <= gb.depth * 0.1))
    return neighbor, ok


def spatial_offset(i: int, looper, radius: float):
    """The frame's shared disk offset (dx, dy) of neighbour i."""
    s1, s2, _, _ = rng.uniform4(torch.tensor(i), looper, _CTR_SPATIAL + i,
                                rng.SALT_RESTIR)
    p = mathx.to_concentric_disk(s1, s2) * radius
    return (int((0.5 + p[0]).to(torch.int32)),
            int((0.5 + p[1]).to(torch.int32)))


def spatial_pack(res_out: rsv.Reservoir, gb: GBufferFrame) -> torch.Tensor:
    """The [C, R] channel pack the spatial taps read: post-temporal
    reservoirs and the G-buffer's prim, normal, depth."""
    return rsv.pack_channels((res_out, gb.prim_id, gb.norm, gb.depth))


def _merge_spatial_neighbors(res_buf: rsv.Reservoir, gb: GBufferFrame,
                             cfg: RenderConfig, pix, looper, pix0: int = 0,
                             img=None, row0: int = 0) -> rsv.Reservoir:
    """Up to `spatial_neighbors` disk neighbours merged into a fresh
    reservoir — mergeSpatialNeighborDirect (restir.cu:87-100). Offsets
    are drawn once per frame and shared by all pixels (a 2-D roll), as in
    the JAX package; the merge draws and rejection stay per pixel.
    `img` ([C, rows, W] of `spatial_pack`, from global row `row0`) holds
    the rows the taps of the pixels pix0 .. reach (default: the frame);
    the roll wraps inside it, and the in-frame test on the global (x, y)
    masks every wrapped tap, as on the whole frame."""
    w, h = cfg.width, cfg.height
    r = pix.shape[0]
    x = pix % w
    y = torch.div(pix, w, rounding_mode="floor")
    template = (res_buf, gb.prim_id, gb.norm, gb.depth)
    if img is None:
        img = rsv.pack_channels(template).reshape(-1, h, w)
    y0 = pix0 // w - row0
    agg = rsv.zeros_direct(r, pix.device)
    for i in range(cfg.spatial_neighbors):
        dx, dy = spatial_offset(i, looper, cfg.spatial_radius)
        shifted = torch.roll(img, (-dy, -dx), dims=(1, 2))[
            :, y0:y0 + r // w].reshape(-1, r)
        neighbor, nprim, nnorm, ndepth = rsv.unpack_channels(shifted,
                                                             template)
        px, py = x + dx, y + dy
        ok = ((px >= 0) & (px < w) & (py >= 0) & (py < h)
              & (not (dx == 0 and dy == 0))
              & (nprim == gb.prim_id)
              & (mathx.dot(gb.norm, nnorm) >= 0.9)
              & (torch.abs(gb.depth - ndepth) <= gb.depth * 0.1)
              & ~rsv.invalid(neighbor))
        r3 = rng.uniform1(pix, looper, _CTR_SPATIAL + i, rng.SALT_RESTIR)
        agg = rsv.merge(agg, neighbor, r3, active=ok)
    return agg


def resolve_ris_mode(cfg: RenderConfig) -> str:
    return "cdf" if cfg.ris_mode == "auto" else cfg.ris_mode


def _ris_cdf(scene, pos, dmat, norm, wo, shade, prim_id, cfg: RenderConfig,
             looper, pix0=0):
    """cdf-mode candidates -> (reservoir, visibility done). On CUDA
    without an env map, kernel B10 runs the winner's shadow ray too.
    Pixel p draws as global pixel pix0 + p."""
    if pos.is_cuda and not cfg.has_env_map:
        li, wi, dist, weight, m = ris_kernel.ris_cdf(
            pos, norm, wo, dmat.type, dmat.metallic, dmat.roughness, shade,
            prim_id, looper, scene.tables, scene.bvh, k=cfg.cdf_candidates,
            single_sided=cfg.single_sided_lights,
            has_met=cfg.scene_has_metallic, pix0=pix0)
        return rsv.Reservoir(sample=rsv.DirectSample(li=li, wi=wi, dist=dist),
                             weight=weight, m=m), True
    parts = []
    for c0 in range(0, pos.shape[0], _RIS_CHUNK):
        sl = slice(c0, c0 + _RIS_CHUNK)
        pix = torch.arange(pix0 + c0, pix0 + c0 + pos[sl].shape[0],
                           device=pos.device)
        mat_c = rsv.tree_map(lambda t: t[sl], dmat)
        with mathx.fused():  # a lax.map body in the JAX package
            parts.append(_ris_cdf_chunk(scene, pix, pos[sl], mat_c, norm[sl],
                                        wo[sl], shade[sl], cfg, looper))
    return rsv.tree_map(lambda *xs: torch.cat(xs), *parts), False


def _ris_cdf_chunk(scene, pix, pos, mat, norm, wo, shade, cfg, looper):
    ws, cands = [], []
    r_sel = None
    for k in range(cfg.cdf_candidates):
        r1, r2, r3, r4 = rng.uniform4(pix, looper, _CTR_RIS + k,
                                      rng.SALT_RESTIR)
        if k == 0:
            r_sel = r4  # the winner's selection draw
        ls = light_ops.sample_light_cdf(scene, pos, norm, r1, r2, r3,
                                        single_sided=cfg.single_sided_lights,
                                        has_env=cfg.has_env_map)
        cand = rsv.DirectSample(li=ls.radiance, wi=ls.wi, dist=ls.dist)
        w = mathx.luminance(_p_hat_direct(cand, mat, norm, wo)) / ls.pdf
        w = torch.where(mathx.is_nan_or_inf(w) | (ls.pdf <= 0.0) | ~shade,
                        0.0, w)
        ws.append(w)
        cands.append(cand)
    # single-draw inverse-CDF winner: P(pick k) = w_k / W
    cums, c = [], ws[0]
    for k in range(1, len(ws)):
        cums.append(c)
        c = c + ws[k]
    total = c
    thresh = r_sel * total
    jsel = torch.zeros_like(total)
    for cj in cums:
        jsel = jsel + (cj <= thresh).to(torch.float32)
    gate = shade & (total > 0.0)
    li = torch.zeros_like(cands[0].li)
    wi = torch.zeros_like(cands[0].wi)
    dist = torch.zeros_like(cands[0].dist)
    for k, cand in enumerate(cands):
        pick = gate & (jsel == float(k))
        li = torch.where(pick[..., None], cand.li, li)
        wi = torch.where(pick[..., None], cand.wi, wi)
        dist = torch.where(pick, cand.dist, dist)
    return rsv.Reservoir(sample=rsv.DirectSample(li=li, wi=wi, dist=dist),
                         weight=total,
                         m=torch.where(shade, len(ws), 0).to(torch.int32))


def _ris_reference(scene, pos, dmat, norm, wo, shade, cfg: RenderConfig,
                   looper, pix0=0):
    """Reference mode: K = ris_candidates streaming updates of NEE
    samples without visibility (restir.cu:156-169)."""
    pix = torch.arange(pix0, pix0 + pos.shape[0], device=pos.device)
    res = rsv.zeros_direct(pos.shape[0], pos.device)
    with mathx.fused():  # a fori_loop body in the JAX package
        for i in range(cfg.ris_candidates):
            res = _ris_reference_candidate(scene, pix, pos, dmat, norm, wo,
                                           shade, cfg, looper, i, res)
    return res


def _ris_reference_candidate(scene, pix, pos, dmat, norm, wo, shade, cfg,
                             looper, i, res):
    l1, l2, l3, l4 = rng.uniform4(pix, looper, _CTR_RIS + 2 * i,
                                  rng.SALT_RESTIR)
    r_upd = rng.uniform1(pix, looper, _CTR_RIS + 2 * i + 1, rng.SALT_RESTIR)
    ls = light_ops.sample_direct_light_no_visibility(
        scene, pos, l1, l2, l3, l4, has_env=cfg.has_env_map,
        single_sided=cfg.single_sided_lights)
    cand = rsv.DirectSample(li=ls.radiance, wi=ls.wi, dist=ls.dist)
    w = mathx.luminance(_p_hat_direct(cand, dmat, norm, wo)) / ls.pdf
    w = torch.where(mathx.is_nan_or_inf(w) | (ls.pdf <= 0.0), 0.0, w)
    return rsv.update(res, cand, w, r_upd, active=shade)


class DirectStage(NamedTuple):
    """What a ReSTIR DI frame carries from its temporal stage to its
    spatial merge and shade."""

    res: rsv.Reservoir  # post-temporal, before check_validity
    res_out: rsv.Reservoir  # what the next frame reuses
    pix: torch.Tensor  # [R] global pixel indices
    pix0: int
    shade: torch.Tensor
    is_light: torch.Tensor
    miss: torch.Tensor
    dmat: object  # the demodulated SurfaceMaterial
    norm: torch.Tensor
    wo: torch.Tensor


def direct_temporal(scene, gb: GBufferFrame, last_gb: GBufferFrame, it, mat,
                    ray_dir, res_in: rsv.Reservoir, cfg: RenderConfig, looper,
                    pix0: int = 0, prev=None,
                    prev_base: int = 0) -> DirectStage:
    """Steps 1-3 on the pixels pix0 .. (global indices): candidates,
    the winner's visibility, the temporal merge. `prev` / `prev_base`
    as in `find_temporal_neighbor`."""
    trv = ix.traversal_arrays(scene, cfg.intersector)
    pix = torch.arange(pix0, pix0 + it.pos.shape[0], device=it.pos.device)
    miss = ~it.valid
    is_light = it.valid & (gb.prim_id == LIGHT_ID)
    shade = it.valid & ~is_light
    # demodulate: base colour 1 (restir.cu:141)
    dmat = mat._replace(base_color=torch.ones_like(mat.base_color))
    wo = -ray_dir
    flip = ~(dmat.type == DIELECTRIC) & (mathx.dot(it.norm, wo) < 0)
    norm = torch.where(flip[..., None], -it.norm, it.norm)

    # 1. candidates without visibility (restir.cu:156-169)
    if resolve_ris_mode(cfg) == "cdf":
        res, vis_done = _ris_cdf(scene, it.pos, dmat, norm, wo, shade,
                                 it.prim_id, cfg, looper, pix0)
    else:
        res = _ris_reference(scene, it.pos, dmat, norm, wo, shade, cfg,
                             looper, pix0)
        vis_done = False
    # 2. the winner's visibility (restir.cu:172-176); env samples carry a
    # far distance, clamped as in sample_direct_light (scene.h:386)
    if not vis_done:
        target = it.pos + res.sample.wi * torch.clamp(res.sample.dist,
                                                      max=1e6)[..., None]
        occluded = ix.test_occlusion(trv, it.pos, target, active=shade,
                                     geom=(cfg.width, pix0))
        res = res._replace(weight=torch.where(occluded, 0.0, res.weight))

    # 3. temporal reuse (restir.cu:180-185)
    if cfg.reuse & ReuseMode.TEMPORAL:
        temporal, ok = find_temporal_neighbor(res_in, gb, last_gb, prev,
                                              prev_base)
        ok = ok & ~rsv.invalid(temporal) & shade
        r_t = rng.uniform1(pix, looper, _CTR_TEMPORAL, rng.SALT_RESTIR)
        res = rsv.pre_clamped_merge(res, temporal, cfg.temporal_clamp, r_t,
                                    active=ok)
    # the post-temporal reservoir is what the next frame reuses
    return DirectStage(res=res, res_out=rsv.check_validity(res), pix=pix,
                       pix0=pix0, shade=shade, is_light=is_light, miss=miss,
                       dmat=dmat, norm=norm, wo=wo)


def direct_shade(st: DirectStage, gb: GBufferFrame, cfg: RenderConfig,
                 looper, img=None, row0: int = 0) -> torch.Tensor:
    """Steps 4-5: the spatial merge (`img` / `row0` as in
    `_merge_spatial_neighbors`) and the shade -> direct radiance
    [R, 3] modulated by the G-buffer albedo."""
    res, shade = st.res, st.shade
    # 4. spatial reuse (restir.cu:190-210)
    if cfg.reuse & ReuseMode.SPATIAL:
        agg = _merge_spatial_neighbors(st.res_out, gb, cfg, st.pix, looper,
                                       st.pix0, img, row0)
        ok = ~rsv.invalid(agg) & ~rsv.invalid(res) & shade
        r_s = rng.uniform1(st.pix, looper,
                           _CTR_SPATIAL + cfg.spatial_neighbors,
                           rng.SALT_RESTIR)
        res = rsv.merge(res, agg, r_s, active=ok)

    # 5. shade (restir.cu:216-226): the demodulated BSDF is grey, so f
    # cancels from Li f / lum(Li f); only its support mask remains
    f_lum = bsdf_ops.eval_bsdf_lum(st.dmat, st.norm, st.wo, res.sample.wi)
    li_lum = mathx.luminance(res.sample.li)
    w_big = res.weight / torch.clamp(res.m.to(torch.float32), min=1.0)
    direct = (res.sample.li / torch.clamp(li_lum, min=1e-20)[..., None]
              * w_big[..., None])
    direct = torch.where((shade & ~rsv.invalid(res) & (f_lum > 0)
                          & (li_lum > 0))[..., None], direct, 0.0)
    direct = mathx.zero_nan_or_inf(direct)
    # demodulated emissive / miss values: 1, so the albedo carries them
    direct = torch.where(st.is_light[..., None], 1.0, direct)
    direct = torch.where(st.miss[..., None], 1.0, direct)
    return direct * gb.albedo


def restir_direct(scene, gb: GBufferFrame, last_gb: GBufferFrame, it, mat,
                  ray_dir, res_in: rsv.Reservoir, cfg: RenderConfig, looper):
    """One ReSTIR DI frame -> (direct radiance [R, 3] modulated by the
    G-buffer albedo, the reservoir for next frame's temporal pass)."""
    st = direct_temporal(scene, gb, last_gb, it, mat, ray_dir, res_in, cfg,
                         looper)
    return direct_shade(st, gb, cfg, looper), st.res_out
