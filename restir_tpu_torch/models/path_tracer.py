"""Reference path tracers, as `restir_tpu.models.path_tracer`
(pathtrace.cu:156-432): the full MIS path tracer, direct-only NEE
(PT-direct, the unbiased A/B target of ReSTIR DI) and indirect-only; and
the BVH heatmap (`bvh_heatmap`: kernel B14 on the card).

The per-thread bounce loop with `break`s is a Python loop over [R] ray
batches with masks, with the JAX package's documented deviations: no
demodulated white writes and no HDR compression before accumulation,
and the self-consistent light pdf.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..ops import bsdf as bsdf_ops
from ..ops import intersect as ix
from ..ops import lights as light_ops
from ..ops.camera import Camera, pixel_centers, sample_rays
from ..ops.kernels import intersect as hit_kernels
from ..ops.primary import trace_primary
from ..ops.texture import env_sample_bilinear
from ..scene.mesh import DIELECTRIC, LIGHT
from ..utils import math as mathx
from ..utils import rng
from .gbuffer import band_size, primary_rays


def _primary_setup(scene, cam: Camera, cfg: RenderConfig, looper, salt,
                   pix0=0, r=None):
    """Camera ray, first hit and textured material, shared by the PTs."""
    trv = ix.traversal_arrays(scene, cfg.intersector)
    pix, o, d = primary_rays(cam, cfg, looper, salt, scene.verts.device,
                             cfg.sampler, pix0, r)
    it, mat, hit = trace_primary(scene, trv, o, d, cfg.with_textures,
                                 geom=(cfg.width, pix0))
    return trv, pix, o, d, hit, it, mat


def _env_radiance(scene, d, cfg):
    if cfg.has_env_map:
        return env_sample_bilinear(scene.env_map, mathx.to_plane(d))
    return torch.zeros_like(d)


def _facing(norm, wo, mat):
    """The shading normal turned toward wo, except on delta lobes."""
    flip = ~(mat.type == DIELECTRIC) & (mathx.dot(norm, wo) < 0)
    return torch.where(flip[..., None], -norm, norm)


def pt_direct(scene, cam: Camera, cfg: RenderConfig, looper, pix0=0,
              r=None):
    """One-bounce NEE-only direct light — PTDirectKernel
    (pathtrace.cu:279-328). Returns radiance [R, 3]; with (pix0, r),
    of the row band of r pixels from global pixel pix0."""
    trv, pix, o, d, hit, it, mat = _primary_setup(scene, cam, cfg, looper,
                                                  rng.SALT_PT, pix0, r)
    miss = ~it.valid
    env = _env_radiance(scene, d, cfg)
    is_light = it.valid & (mat.type == LIGHT)
    wo = -d
    delta = mat.type == DIELECTRIC
    norm = _facing(it.norm, wo, mat)
    l1, l2, l3, l4 = rng.draw4(cfg.sampler, pix, looper, 1, rng.SALT_PT)
    shade = it.valid & ~is_light & ~delta
    ls = light_ops.sample_direct_light(
        scene, trv, it.pos, l1, l2, l3, l4, has_env=cfg.has_env_map,
        single_sided=cfg.single_sided_lights, active=shade,
        geom=(cfg.width, pix0))
    f = bsdf_ops.eval_bsdf(mat, norm, wo, ls.wi)
    contrib = ls.radiance * f * (mathx.sat_dot(norm, ls.wi)
                                 / torch.clamp(ls.pdf, min=1e-20))[..., None]
    direct = torch.where((shade & (ls.pdf > 0))[..., None], contrib, 0.0)
    direct = torch.where(is_light[..., None], mat.base_color, direct)
    direct = torch.where(miss[..., None], env, direct)
    return mathx.zero_nan_or_inf(direct)


def pt_trace(scene, cam: Camera, cfg: RenderConfig, looper, pix0=0,
             r=None):
    """Full MIS path tracer — singleKernelPT (pathtrace.cu:156-277).
    Returns (direct [R, 3], indirect [R, 3]): depth-1 NEE is direct,
    everything else indirect. (pix0, r) as in `pt_direct`."""
    trv, pix, o, d, hit, it, mat = _primary_setup(scene, cam, cfg, looper,
                                                  rng.SALT_PT, pix0, r)
    miss = ~it.valid
    env = _env_radiance(scene, d, cfg)
    direct = torch.where(miss[..., None], env, 0.0)
    indirect = torch.zeros_like(direct)
    is_light = it.valid & (mat.type == LIGHT)
    light_vis = is_light
    if cfg.single_sided_lights:
        light_vis = is_light & (mathx.dot(it.norm, d) < 0)
    direct = direct + torch.where(light_vis[..., None], mat.base_color, 0.0)

    alive = it.valid & ~is_light
    throughput = torch.ones_like(direct)
    pos, norm, wo = it.pos, it.norm, -d
    for depth in range(1, cfg.trace_depth + 1):
        with mathx.fused():  # a lax.scan body in the JAX package
            direct, indirect, alive, throughput, pos, norm, wo, mat = _bounce(
                scene, trv, cfg, pix, looper, depth, direct, indirect, alive,
                throughput, pos, norm, wo, mat, (cfg.width, pix0))
    return mathx.zero_nan_or_inf(direct), mathx.zero_nan_or_inf(indirect)


def _bounce(scene, trv, cfg, pix, looper, depth, direct, indirect, alive,
            throughput, pos, norm, wo, mat, geom):
    """One bounce of pt_trace: NEE at the current vertex, then a BSDF
    sample and its hit, with MIS on env and light hits; `geom` (width,
    pix0) of the pixels `pix`."""
    delta_bsdf = mat.type == DIELECTRIC
    norm = _facing(norm, wo, mat)

    # NEE (pathtrace.cu:202-212)
    ctr = 1 + (depth - 1) * 2
    l1, l2, l3, l4 = rng.draw4(cfg.sampler, pix, looper, ctr, rng.SALT_PT)
    shade = alive & ~delta_bsdf
    ls = light_ops.sample_direct_light(
        scene, trv, pos, l1, l2, l3, l4, has_env=cfg.has_env_map,
        single_sided=cfg.single_sided_lights, active=shade, geom=geom)
    f = bsdf_ops.eval_bsdf(mat, norm, wo, ls.wi)
    bsdf_pdf = bsdf_ops.pdf_bsdf(mat, norm, wo, ls.wi)
    mis_w = mathx.power_heuristic(ls.pdf, bsdf_pdf)
    nee = throughput * f * ls.radiance * (
        mathx.sat_dot(norm, ls.wi) * mis_w
        / torch.clamp(ls.pdf, min=1e-20))[..., None]
    nee = torch.where((shade & (ls.pdf > 0))[..., None], nee, 0.0)
    # multiplied, not selected, as the JAX loop does (an Inf NEE
    # turns the other sum NaN, and zero_nan_or_inf then drops it)
    direct = direct + (1.0 if depth == 1 else 0.0) * nee
    indirect = indirect + (0.0 if depth == 1 else 1.0) * nee

    # BSDF bounce (pathtrace.cu:214-263)
    b1, b2, b3, _ = rng.draw4(cfg.sampler, pix, looper, ctr + 1,
                              rng.SALT_PT)
    bs = bsdf_ops.sample_bsdf(mat, norm, wo, (b1, b2, b3))
    ok = alive & ~bsdf_ops.is_invalid(bs.type) & (bs.pdf >= 1e-8)
    delta_sample = bsdf_ops.is_delta(bs.type)
    weight = torch.where(delta_sample, 1.0, mathx.abs_dot(norm, bs.wi))
    throughput = torch.where(
        ok[..., None],
        throughput * bs.f * (weight / torch.clamp(bs.pdf, min=1e-20))[
            ..., None],
        throughput)
    alive = ok

    ro, rd = ix.make_offseted_ray(pos, bs.wi)
    new_it, new_mat, _ = trace_primary(scene, trv, ro, rd,
                                       cfg.with_textures, active=alive,
                                       geom=geom)
    # env miss with MIS (pathtrace.cu:235-245)
    if cfg.has_env_map:
        env_r = env_sample_bilinear(scene.env_map, mathx.to_plane(rd))
        env_pdf = light_ops.env_map_pdf(scene, rd)
        w = torch.where(delta_sample, 1.0,
                        mathx.power_heuristic(bs.pdf, env_pdf))
        hit_env = alive & ~new_it.valid
        indirect = indirect + torch.where(
            hit_env[..., None], env_r * throughput * w[..., None], 0.0)
    alive = alive & new_it.valid

    # light hit with MIS (pathtrace.cu:248-263)
    hit_light = alive & (new_mat.type == LIGHT)
    lit = hit_light
    if cfg.single_sided_lights:
        lit = hit_light & (mathx.dot(new_it.norm, rd) < 0)
    le = new_mat.base_color
    light_pdf_area = (mathx.luminance(le) * 2.0 * mathx.PI
                      * scene.sum_light_power_inv)
    light_pdf = mathx.pdf_area_to_solid_angle(light_pdf_area, pos,
                                              new_it.pos, new_it.norm)
    w = torch.where(delta_sample, 1.0,
                    mathx.power_heuristic(bs.pdf, light_pdf))
    indirect = indirect + torch.where(lit[..., None],
                                      le * throughput * w[..., None], 0.0)
    alive = alive & ~hit_light
    return (direct, indirect, alive, throughput, new_it.pos, new_it.norm,
            -rd, new_mat)


def pt_indirect(scene, cam: Camera, cfg: RenderConfig, looper, pix0=0,
                r=None):
    """Indirect-only — PTIndirectKernel (pathtrace.cu:330-432)."""
    return pt_trace(scene, cam, cfg, looper, pix0, r)[1]


def bvh_heatmap(scene, cam: Camera, cfg: RenderConfig, pix0=0, r=None):
    """BVH traversal cost view — visualizedIntersect (scene.h:318-356):
    each pixel-centre camera ray's count of descended MTBVH nodes (int32
    [R]), on any intersector method. (pix0, r) as in `pt_direct`; the
    batch carries its band's geometry, for B14's 8x4-pixel warps."""
    trv = ix.traversal_arrays(scene, cfg.intersector, walk=True)
    x, y = pixel_centers(cfg.width, cfg.height, scene.verts.device, pix0,
                         band_size(cfg, pix0, r))
    o, d = sample_rays(cam, cfg.width, cfg.height, x, y,
                       torch.full_like(x, 0.5), torch.full_like(y, 0.5))
    return hit_kernels.heatmap(trv, o, d, geom=(cfg.width, pix0))
