"""ReSTIR GI, as `restir_tpu.models.restir_gi` (restir.cu:242-416).

Per pixel and frame:
  1. trace one path from the shared primary hit: its first BSDF bounce
     defines the visible point xv / nv and the sample point xs / ns, and
     its pdf stays out of the reservoir target (RIS divides by it);
  2. accumulate the path's outgoing radiance Lo at xs: NEE from depth 2
     with MIS, BSDF bounces, light (and env) hits with MIS;
  3. a reservoir update with w = lum(Lo) / pdf, NaN and negatives zeroed;
  4. the temporal merge at the motion index, then the M cap;
  5. the shade Lo / lum(Lo) W / M f cos on the demodulated material.

Two routes, as in the JAX package:
- the fused one (`restir_indirect_fused`, taken when the reservoir is the
  [Q_CH, R] resolve pack of `init_gi_resolve_pack`): kernel B8 traces,
  kernel B9 resolves (`ops.kernels.gi`);
- the general one (`restir_indirect`, a `Reservoir` of [R, ...] tensors):
  `trace_gi_sample`, then the reservoir steps in torch. On CUDA tensors
  the trace takes B8 when `gi_fused_eligible` passes, as the JAX package
  does on the TPU; otherwise (and on CPU tensors) the torch bounce loop,
  whose hits go through B12 and B11's any hit on the card.

A row band (`restir_tpu_torch.parallel`) passes `pix0`, its first
global pixel, which keys every draw (B8's, B9's and the torch loop's),
and the previous frame's reservoir as a fetched range of global pixels
from `prev_base` (the reach of its motion indices).

The bounce loop is a Python loop over [R] batches with masks; on CPU
tensors each bounce runs inside `utils.math.fused()`, since the JAX
package runs it as a `lax.scan` body.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig, ReuseMode
from ..ops import bsdf as bsdf_ops
from ..ops import intersect as ix
from ..ops import lights as light_ops
from ..ops import reservoir as rsv
from ..ops.kernels import gi as gk
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.mesh import DIELECTRIC, LIGHT
from ..utils import math as mathx
from ..utils import rng
from .gbuffer import LIGHT_ID, GBufferFrame
from .restir_di import find_temporal_neighbor


def _p_hat_gi(sample: rsv.IndirectSample) -> torch.Tensor:
    """Target p_hat = lum(Lo) (restir.cu:233-236, the Lo-only variant)."""
    return mathx.luminance(sample.lo)


def gi_gate_failures(scene, cfg: RenderConfig, r: int, resolve=True):
    """The parts of the GI gate `cfg` fails on `scene`: B8's
    (restir_gi.py:56-68: pcg4d streams, no env map, no loaded textures
    (procedural base colours are B8's), at most 1024 triangles) and,
    with `resolve`, B9's whole 1024-pixel tiles (:285-292)."""
    fails = []
    if cfg.sampler != "pcg4d":
        fails.append(f"sampler {cfg.sampler!r}")
    if cfg.has_env_map:
        fails.append("env map (has_env_map)")
    if cfg.with_textures or scene.tex_data.shape[0] > 1:
        fails.append("textures")  # tex_data is a dummy [1, 3] without
    if scene.verts.shape[0] > gk.MAX_TRIS:
        fails.append(f"{scene.verts.shape[0]} triangles > {gk.MAX_TRIS}")
    if resolve and r % gk.TILE:
        fails.append(f"{r} pixels not a multiple of {gk.TILE}")
    return fails


def gi_fused_eligible(scene, cfg: RenderConfig, r: int) -> bool:
    """Static gate of kernel B8; the kernel takes any pixel count."""
    return not gi_gate_failures(scene, cfg, r, resolve=False)


def gi_resolve_fused_eligible(scene, cfg: RenderConfig, r: int) -> bool:
    """Static gate of the fused GI stage (B8 + B9): B8's gate and whole
    1024-pixel tiles. The windowed temporal gather inherits the fused DI
    deviation (a motion index outside the tile's 2048-pixel window gets
    no temporal reuse)."""
    return not gi_gate_failures(scene, cfg, r)


def _build_gi_in_pack(it, mat, ray_dir) -> torch.Tensor:
    """[IN_CH, R] trace input pack from the primary-hit structs."""
    alive = it.valid & (mat.type != LIGHT)
    zeros = torch.zeros_like(mat.metallic)
    return torch.stack([
        it.pos[:, 0], it.pos[:, 1], it.pos[:, 2],
        it.norm[:, 0], it.norm[:, 1], it.norm[:, 2],
        ray_dir[:, 0], ray_dir[:, 1], ray_dir[:, 2],
        mat.type.to(torch.float32), mat.metallic, mat.roughness, mat.ior,
        alive.to(torch.float32), zeros, zeros])


def trace_kwargs(scene, cfg: RenderConfig, pix0: int = 0):
    """B8's keyword arguments for `cfg` on `scene`."""
    return dict(depth=cfg.trace_depth, single_sided=cfg.single_sided_lights,
                n_lights=int(scene.light_prob.shape[0]), pix0=pix0,
                has_met=cfg.scene_has_metallic,
                has_die=cfg.scene_has_dielectric,
                has_proc=cfg.scene_has_procedural)


def _sample_from_go(go, xv):
    """(sample, prim_pdf, prim_delta, valid) from a [GO_CH, R] pack, the
    epilogue of trace_gi_sample_fused."""
    lo = mathx.zero_nan_or_inf(go[gk.GO_LO:gk.GO_LO + 3].T)
    xs = go[gk.GO_XS:gk.GO_XS + 3].T
    sample = rsv.IndirectSample(lo=lo, xv=xv,
                                nv=go[gk.GO_NV:gk.GO_NV + 3].T, xs=xs,
                                ns=go[gk.GO_NS:gk.GO_NS + 3].T)
    valid = (mathx.luminance(lo) >= 1e-8) & (mathx.length(xs - xv) > 0.0)
    return sample, go[gk.GO_PDF], go[gk.GO_DELTA] > 0.5, valid


def trace_gi_sample_fused(scene, it, mat, ray_dir, cfg: RenderConfig, looper,
                          pix0: int = 0):
    """The trace through kernel B8 (its twin on CPU tensors); pixel p
    draws its streams as pixel pix0 + p."""
    go = gk.gi_trace(_build_gi_in_pack(it, mat, ray_dir), looper, scene,
                     **trace_kwargs(scene, cfg, pix0))
    return _sample_from_go(go, it.pos)


def _gi_bounce(scene, trv, pix, looper, depth: int, carry, *, single_sided,
               has_env, with_textures, plain, geom):
    """One bounce of the path loop (restir_gi.py:170-260); `geom` (width,
    pix0) of the pixels `pix`, or None."""
    (lo, nv, xs, ns, prim_pdf, prim_delta, alive, throughput, pos, norm, wo,
     cur_mat) = carry
    first = depth == 1
    delta_bsdf = cur_mat.type == DIELECTRIC
    norm = torch.where((~delta_bsdf & (mathx.dot(norm, wo) < 0))[..., None],
                       -norm, norm)
    if first:
        nv = norm  # xv's normal after the orientation fix

    ctr = gk.CTR_PATH + (depth - 1) * 2
    if not first:  # NEE from depth 2 (restir.cu:290-300)
        l1, l2, l3, l4 = rng.uniform4(pix, looper, ctr, gk.SALT_GI)
        shade = alive & ~delta_bsdf
        ls = light_ops.sample_direct_light(
            scene, trv, pos, l1, l2, l3, l4, has_env=has_env,
            single_sided=single_sided, active=shade, plain=plain,
            geom=geom)
        f = bsdf_ops.eval_bsdf(cur_mat, norm, wo, ls.wi)
        bsdf_pdf = bsdf_ops.pdf_bsdf(cur_mat, norm, wo, ls.wi)
        mis_w = mathx.power_heuristic(ls.pdf, bsdf_pdf)
        nee = throughput * f * ls.radiance * (
            mathx.sat_dot(norm, ls.wi) * mis_w
            / torch.clamp(ls.pdf, min=1e-20))[..., None]
        lo = lo + torch.where((shade & (ls.pdf > 0))[..., None], nee, 0.0)

    # BSDF bounce (restir.cu:302-325)
    b1, b2, b3, _ = rng.uniform4(pix, looper, ctr + 1, gk.SALT_GI)
    bs = bsdf_ops.sample_bsdf(cur_mat, norm, wo, (b1, b2, b3))
    ok = alive & ~bsdf_ops.is_invalid(bs.type) & (bs.pdf >= 1e-8)
    delta_sample = bsdf_ops.is_delta(bs.type)
    if first:
        prim_pdf = torch.where(ok, bs.pdf, prim_pdf)
        prim_delta = torch.where(ok, delta_sample, prim_delta)
    else:
        weight = torch.where(delta_sample, 1.0, mathx.abs_dot(norm, bs.wi))
        throughput = torch.where(
            ok[..., None],
            throughput * bs.f * (weight / torch.clamp(bs.pdf, min=1e-20))[
                ..., None],
            throughput)
    alive = ok

    ro, rd = ix.make_offseted_ray(pos, bs.wi)
    new_it, new_mat, _ = trace_primary(scene, trv, ro, rd, with_textures,
                                       active=alive, plain=plain, geom=geom)
    if has_env:  # env miss with MIS (restir.cu:331-342)
        env_r = env_sample_bilinear(scene.env_map, mathx.to_plane(rd))
        env_pdf = light_ops.env_map_pdf(scene, rd)
        w = torch.where(delta_sample, 1.0,
                        mathx.power_heuristic(bs.pdf, env_pdf))
        hit_env = alive & ~new_it.valid
        lo = lo + torch.where(hit_env[..., None],
                              env_r * throughput * w[..., None], 0.0)
    alive = alive & new_it.valid

    # light hit with MIS (restir.cu:345-367)
    hit_light = alive & (new_mat.type == LIGHT)
    lit = hit_light
    if single_sided:
        lit = hit_light & (mathx.dot(new_it.norm, rd) < 0)
    le = new_mat.base_color
    if first:
        w = torch.ones_like(bs.pdf)
    else:
        light_pdf_area = (mathx.luminance(le) * 2.0 * mathx.PI
                          * scene.sum_light_power_inv)
        light_pdf = mathx.pdf_area_to_solid_angle(light_pdf_area, pos,
                                                  new_it.pos, new_it.norm)
        w = torch.where(delta_sample, 1.0,
                        mathx.power_heuristic(bs.pdf, light_pdf))
    lo = lo + torch.where(lit[..., None], le * throughput * w[..., None],
                          0.0)

    # the sample point, light or surface (restir.cu:362-372)
    if first:
        got = ok & new_it.valid
        xs = torch.where(got[..., None], new_it.pos, xs)
        ns = torch.where(got[..., None], new_it.norm, ns)
    alive = alive & ~hit_light
    return (lo, nv, xs, ns, prim_pdf, prim_delta, alive, throughput,
            new_it.pos, new_it.norm, -rd, new_mat)


def _trace_paths(scene, pos, norm, wo, mat, alive, *, depth, single_sided,
                 has_env, with_textures, looper, pix0=0, plain=False,
                 intersector="auto", width=None):
    """The bounce loop -> raw (lo, nv, xs, ns, prim_pdf, prim_delta);
    `plain` casts every ray with `intersect_bf` (B8's twin). With the
    frame's `width`, pixel p is global pixel pix0 + p of that frame (the
    geometry of B13's launch)."""
    trv = ix.traversal_arrays(scene, intersector)
    r = pos.shape[0]
    dev = pos.device
    pix = torch.arange(pix0, pix0 + r, device=dev)
    z3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    carry = (z3, norm, z3, z3, torch.ones((r,), device=dev),
             torch.zeros((r,), dtype=torch.bool, device=dev), alive,
             torch.ones((r, 3), device=dev), pos, norm, wo, mat)
    kw = dict(single_sided=single_sided, has_env=has_env,
              with_textures=with_textures, plain=plain,
              geom=None if width is None else (width, pix0))
    for d in range(1, depth + 1):
        with mathx.fused():  # a lax.scan body in the JAX package
            carry = _gi_bounce(scene, trv, pix, looper, d, carry, **kw)
    return carry[:6]


def trace_gi_sample(scene, it, mat, ray_dir, cfg: RenderConfig, looper,
                    pix0: int = 0):
    """One indirect path sample per pixel -> (sample, prim_sample_pdf [R],
    prim_delta [R] bool, valid [R] bool). Pixel p draws its streams as
    pixel pix0 + p."""
    if it.pos.is_cuda and gi_fused_eligible(scene, cfg, it.pos.shape[0]):
        return trace_gi_sample_fused(scene, it, mat, ray_dir, cfg, looper,
                                     pix0)
    lo, nv, xs, ns, prim_pdf, prim_delta = _trace_paths(
        scene, it.pos, it.norm, -ray_dir, mat,
        it.valid & (mat.type != LIGHT), depth=cfg.trace_depth,
        single_sided=cfg.single_sided_lights, has_env=cfg.has_env_map,
        with_textures=cfg.with_textures, looper=looper, pix0=pix0,
        intersector=cfg.intersector, width=cfg.width)
    sample = rsv.IndirectSample(lo=mathx.zero_nan_or_inf(lo), xv=it.pos,
                                nv=nv, xs=xs, ns=ns)
    # invalid() == lum(Lo) < 1e-8 (restir.h:16-18), and a recorded
    # secondary point
    valid = ((mathx.luminance(sample.lo) >= 1e-8)
             & (mathx.length(xs - it.pos) > 0.0))
    return sample, prim_pdf, prim_delta, valid


def _gq_pack(gb: GBufferFrame, it) -> torch.Tensor:
    """[GQ_CH, R] G-buffer rows of the resolve."""
    shade = it.valid & (gb.prim_id != LIGHT_ID)
    return torch.stack([
        gb.motion.to(torch.float32), gb.prim_id.to(torch.float32), gb.depth,
        gb.norm[:, 0], gb.norm[:, 1], gb.norm[:, 2],
        gb.albedo[:, 0], gb.albedo[:, 1], gb.albedo[:, 2],
        shade.to(torch.float32)])


def restir_indirect_fused(scene, gb: GBufferFrame, it, mat, ray_dir,
                          q_prev: torch.Tensor, cfg: RenderConfig, looper,
                          pix0: int = 0, prev_base: int = 0, r_prev=None):
    """The fused GI frame: B8's pack feeds B9 (RIS, windowed temporal
    merge, cap, shade) -> (indirect [R, 3], next resolve pack
    [Q_CH, R]). A row band passes B9's band arguments (`pix0`; `q_prev`
    holding global pixels from `prev_base` of `r_prev`)."""
    in_pack = _build_gi_in_pack(it, mat, ray_dir)
    go = gk.gi_trace(in_pack, looper, scene,
                     **trace_kwargs(scene, cfg, pix0))
    ind, q = gk.gi_resolve(go, in_pack, _gq_pack(gb, it), q_prev, looper,
                           temporal=bool(cfg.reuse & ReuseMode.TEMPORAL),
                           temporal_clamp=cfg.temporal_clamp,
                           has_met=cfg.scene_has_metallic, pix0=pix0,
                           prev_base=prev_base, r_prev=r_prev)
    return ind.T, q


def init_gi_resolve_pack(r: int, device="cuda") -> torch.Tensor:
    """A zero [Q_CH, R] resolve pack: its normal (0, 0, 0) fails the
    |dot| >= 0.9 test, so the first frame merges nothing."""
    return torch.zeros((gk.Q_CH, r), dtype=torch.float32, device=device)


def restir_indirect(scene, gb: GBufferFrame, last_gb: GBufferFrame, it, mat,
                    ray_dir, res_in, cfg: RenderConfig, looper, pix0: int = 0,
                    prev=None, prev_base: int = 0, r_prev=None):
    """One ReSTIR GI frame -> (indirect radiance [R, 3], the reservoir for
    the next frame's temporal pass). A [Q_CH, R] tensor as `res_in` (the
    resolve pack `renderer.init_state` allocates on eligible configs)
    routes the frame through `restir_indirect_fused`. A row band of the
    pixels pix0 .. passes the previous frame's fields its motion indices
    reach as `prev` (global pixels from `prev_base`: the resolve pack's
    columns, or `restir_di.temporal_pack`'s) and the previous frame's
    pixel count `r_prev`."""
    if isinstance(res_in, torch.Tensor):
        return restir_indirect_fused(
            scene, gb, it, mat, ray_dir, res_in if prev is None else prev,
            cfg, looper, pix0, prev_base, r_prev)
    r = it.pos.shape[0]
    dev = it.pos.device
    pix = torch.arange(pix0, pix0 + r, device=dev)
    sample, prim_pdf, prim_delta, valid = trace_gi_sample(
        scene, it, mat, ray_dir, cfg, looper, pix0)

    # RIS weight (restir.cu:375-385)
    w = _p_hat_gi(sample) / torch.clamp(prim_pdf, min=1e-20)
    w = torch.where(mathx.is_nan_or_inf(w) | (w < 0) | ~valid, 0.0, w)
    r_upd = rng.uniform1(pix, looper, gk.CTR_UPDATE, gk.SALT_GI)
    res = rsv.update(rsv.zeros_indirect(r, dev), sample, w, r_upd)

    if cfg.reuse & ReuseMode.TEMPORAL:
        temporal, ok = find_temporal_neighbor(res_in, gb, last_gb, prev,
                                              prev_base)
        ok = ok & ~rsv.invalid(temporal)
        r_t = rng.uniform1(pix, looper, gk.CTR_TEMPORAL, gk.SALT_GI)
        res = rsv.merge(res, temporal, r_t, active=ok)
    res = rsv.clamp(res, cfg.temporal_clamp)  # restir.cu:397

    # shade at the primary hit (restir.cu:399-408), demodulated
    dmat = mat._replace(base_color=torch.ones_like(mat.base_color))
    s = res.sample
    prim_wi = mathx.safe_normalize(s.xs - s.xv)
    wo = -ray_dir
    scalar = mathx.luminance(s.lo)
    w_big = res.weight / torch.clamp(res.m.to(torch.float32), min=1.0)
    indirect = (s.lo / torch.clamp(scalar, min=1e-20)[..., None]
                * w_big[..., None])
    f = bsdf_ops.eval_bsdf(dmat, s.nv, wo, prim_wi)
    cosw = torch.where(prim_delta, 1.0, mathx.sat_dot(s.nv, prim_wi))
    indirect = indirect * f * cosw[..., None]
    shade = it.valid & (gb.prim_id != LIGHT_ID)
    indirect = torch.where((shade & ~rsv.invalid(res) & (scalar > 0))[
        ..., None], indirect, 0.0)
    indirect = mathx.zero_nan_or_inf(indirect)
    return indirect * gb.albedo, rsv.check_validity(res)
