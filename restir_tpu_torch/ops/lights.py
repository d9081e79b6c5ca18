"""Next-event estimation, as `restir_tpu.ops.lights`: alias-table light
and env-map sampling (scene.h:358-459) and the per-pixel light CDF.

pdfs are solid-angle at the shading point; pdf <= 0 (INVALID_PDF) marks
a failed or occluded sample. pdf_area = luminance(Le) * 2 pi *
sum_light_power_inv, consistent with the alias table's weights (see
`scene.scene_data`). The JAX package's ray-chunked wrappers bound XLA's
temporaries; eager PyTorch needs none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.alias_table import sample_alias
from ..utils import math as mathx
from . import intersect as ix
from . import intersect_bf
from .texture import env_sample_bilinear

INVALID_PDF = -1.0
ENV_DIST = 1.0e8  # distance carried by env-map samples of the CDF sampler


class LightSample(NamedTuple):
    pdf: torch.Tensor  # [R] solid-angle pdf (INVALID_PDF on failure)
    radiance: torch.Tensor  # [R, 3]
    wi: torch.Tensor  # [R, 3]
    dist: torch.Tensor  # [R]


def _env_pdf(scene, radiance):
    """lum * W * H / (2 pi^2 * sum) (scene.h:373-374)."""
    eh, ew = scene.env_map.shape[0], scene.env_map.shape[1]
    return (mathx.luminance(radiance) * scene.sum_light_power_inv
            * (ew * eh) * mathx.INV_PI * mathx.INV_PI * 0.5)


def env_map_pdf(scene, w):
    """Solid-angle pdf of the env sampler for direction w."""
    return _env_pdf(scene, env_sample_bilinear(scene.env_map,
                                               mathx.to_plane(w)))


def _sample_env_map(scene, r3, r4):
    """A texel by the luminance * sin(theta) alias table — scene.h:364-375."""
    eh, ew = scene.env_map.shape[0], scene.env_map.shape[1]
    pix = sample_alias(scene.env_prob, scene.env_alias, r3, r4)
    y = torch.div(pix, ew, rounding_mode="floor")
    x = pix - y * ew
    radiance = scene.env_map.reshape(-1, 3)[pix]
    uv = torch.stack([(x.to(torch.float32) + 0.5) / ew,
                      (y.to(torch.float32) + 0.5) / eh], dim=-1)
    return _env_pdf(scene, radiance), radiance, mathx.to_sphere(uv)


def sample_direct_light_no_visibility(scene, pos, r1, r2, r3, r4,
                                      has_env: bool,
                                      single_sided: bool = True
                                      ) -> LightSample:
    """DevScene::sampleDirectLightNoVisibility (scene.h:394-425)."""
    n_entries = scene.light_prob.shape[0]
    light_id = sample_alias(scene.light_prob, scene.light_alias, r1, r2)
    nl = scene.light_prim_ids.shape[0]
    prim = scene.light_prim_ids[torch.clamp(light_id, max=nl - 1)].long()
    tri = scene.verts[prim]
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    sampled = mathx.sample_triangle_uniform(v0, v1, v2, r3, r4)
    normal = mathx.triangle_normal(v0, v1, v2)
    to_sampled = sampled - pos
    radiance = scene.light_radiance[
        torch.clamp(light_id, max=scene.light_radiance.shape[0] - 1)]
    wi = mathx.safe_normalize(to_sampled)
    dist = mathx.length(to_sampled)
    pdf_area = (mathx.luminance(radiance) * 2.0 * mathx.PI
                * scene.sum_light_power_inv)
    pdf = mathx.pdf_area_to_solid_angle(pdf_area, pos, sampled, normal)
    if single_sided:  # SCENE_LIGHT_SINGLE_SIDED (scene.h:414-418)
        front = mathx.dot(normal, to_sampled) <= -1e-6
        pdf = torch.where(front, pdf, INVALID_PDF)
    if has_env:
        env_pdf, env_rad, env_wi = _sample_env_map(scene, r3, r4)
        is_env = light_id == n_entries - 1
        pdf = torch.where(is_env, env_pdf, pdf)
        radiance = torch.where(is_env[..., None], env_rad, radiance)
        wi = torch.where(is_env[..., None], env_wi, wi)
        dist = torch.where(is_env, 1e10, dist)
    return LightSample(pdf=pdf, radiance=radiance, wi=wi, dist=dist)


def light_targets(scene, pos, norm, single_sided=True, has_env=False):
    """The per-pixel target matrix [R, L (+ env tiles)] of the light CDF:
    T_l = lum_l area_l relu(n.(c_l - x)) side(n_l.(x - c_l)) / d^4 at each
    light's centroid, as three small float32 products."""
    nl = scene.light_verts.shape[0]
    dev = pos.device
    ones_l = torch.ones((nl, 1), device=dev)
    lc, ln = scene.light_center, scene.light_normal

    n_dot_x = mathx.dot(norm, pos)
    a = mathx.matmul_f32(torch.cat([norm, -n_dot_x[..., None]], dim=-1),
                    torch.cat([lc, ones_l], dim=-1).T)
    b = mathx.matmul_f32(
        torch.cat([pos, torch.ones_like(n_dot_x[..., None])], dim=-1),
        torch.cat([ln, -mathx.dot(ln, lc)[..., None]], dim=-1).T)
    x2 = mathx.dot(pos, pos)
    c2 = mathx.dot(lc, lc)
    d2 = torch.clamp(mathx.matmul_f32(
        torch.cat([-2.0 * pos, torch.ones_like(x2[..., None]),
                   x2[..., None]], dim=-1),
        torch.cat([lc, c2[..., None], ones_l], dim=-1).T), min=1e-8)

    lum_area = mathx.luminance(scene.light_radiance) * scene.light_area
    side = b > 0.0 if single_sided else torch.abs(b) > 0.0
    # conservative horizon cull at the centroid, with a clamped positive
    # weight for lights straddling the tangent plane (lights.py:227-236)
    rad = scene.light_radius
    above = (a + rad[None, :]) > 0.0
    a_eff = torch.maximum(a, 0.1 * rad[None, :])
    t = torch.where(above & side,
                    lum_area[None, :] * a_eff * torch.abs(b) / (d2 * d2), 0.0)
    if has_env:
        # the env tile grid joins the CDF as virtual lights
        d_t = mathx.to_sphere(scene.env_tile_uv[:, 0:2]
                              + 0.5 * scene.env_tile_uv[:, 2:4])
        a_env = mathx.matmul_f32(norm, d_t.T)
        ang = 0.5 * torch.sqrt((mathx.PI * scene.env_tile_uv[:, 3]) ** 2
                               + (mathx.TWO_PI * scene.env_tile_uv[:, 2]) ** 2)
        lum_sa = mathx.luminance(scene.env_tile_rad) * scene.env_tile_sa
        t_env = torch.where((a_env + ang[None, :]) > 0.0,
                            lum_sa[None, :] * torch.maximum(
                                a_env, 0.1 * ang[None, :]), 0.0)
        t = torch.cat([t, t_env], dim=-1)
    return t


def sample_light_cdf(scene, pos, norm, r1, r2, r3, single_sided=True,
                     has_env=False) -> LightSample:
    """One draw from the exact per-pixel CDF over all lights (and the env
    tiles with `has_env`); the pdf is exact (selection x uniform point)."""
    t = light_targets(scene, pos, norm, single_sided, has_env)
    return sample_from_targets(scene, t, pos, r1, r2, r3, single_sided,
                               has_env)


def sample_from_targets(scene, t, pos, r1, r2, r3, single_sided=True,
                        has_env=False) -> LightSample:
    """The draw of `sample_light_cdf` from a target matrix t."""
    nl = scene.light_verts.shape[0]
    ln = scene.light_normal
    n_rows = t.shape[-1]
    cdf = mathx.cumsum(t)
    total = cdf[:, -1]
    has_any = total > 0.0
    idx = torch.clamp((cdf <= (r1 * total)[..., None]).sum(dim=-1),
                      max=n_rows - 1)
    q = torch.gather(t, 1, idx[:, None])[:, 0] / torch.clamp(total, min=1e-20)

    aidx = torch.clamp(idx, max=nl - 1)
    tri = scene.light_verts[aidx]
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    sampled = mathx.sample_triangle_uniform(v0, v1, v2, r2, r3)
    lnormal = ln[aidx]
    area = scene.light_area[aidx]
    radiance = scene.light_radiance[aidx]
    to_sampled = sampled - pos
    wi = mathx.safe_normalize(to_sampled)
    dist = mathx.length(to_sampled)
    pdf = q * mathx.pdf_area_to_solid_angle(
        1.0 / torch.clamp(area, min=1e-20), pos, sampled, lnormal)
    if single_sided:
        pdf = torch.where(mathx.dot(lnormal, to_sampled) <= -1e-6, pdf,
                          INVALID_PDF)
    pdf = torch.where(has_any & (q > 0.0), pdf, INVALID_PDF)

    if has_env:
        is_env = idx >= nl
        eidx = torch.clamp(idx - nl, min=0)
        euv = scene.env_tile_uv[eidx]
        u_s = euv[..., 0] + r2 * euv[..., 2]
        v_s = euv[..., 1] + r3 * euv[..., 3]
        wi_env = mathx.to_sphere(torch.stack([u_s, v_s], dim=-1))
        st = torch.clamp(torch.sin(v_s * mathx.PI), min=1e-6)
        # uv-uniform in the tile: d(omega) = 2 pi^2 sin(theta) du dv
        pdf_env = q / torch.clamp(
            euv[..., 2] * euv[..., 3] * 2.0 * mathx.PI * mathx.PI * st,
            min=1e-20)
        pdf_env = torch.where(has_any & (q > 0.0), pdf_env, INVALID_PDF)
        pdf = torch.where(is_env, pdf_env, pdf)
        radiance = torch.where(is_env[..., None], scene.env_tile_rad[eidx],
                               radiance)
        wi = torch.where(is_env[..., None], wi_env, wi)
        dist = torch.where(is_env, ENV_DIST, dist)
    return LightSample(pdf=pdf, radiance=radiance, wi=wi, dist=dist)


def sample_direct_light(scene, trv: ix.TraversalArrays, pos, r1, r2, r3, r4,
                        has_env: bool, single_sided: bool = True,
                        active=None, plain: bool = False,
                        geom=None) -> LightSample:
    """DevScene::sampleDirectLight (scene.h:427-459): an NEE sample and
    its shadow ray; occluded samples get INVALID_PDF. `plain` casts the
    shadow ray with `intersect_bf` on any device (kernel twins). `geom`
    (width, pix0): one sample per pixel from global pixel pix0 of a frame
    `width` wide (`ix.test_occlusion`)."""
    ls = sample_direct_light_no_visibility(scene, pos, r1, r2, r3, r4,
                                           has_env=has_env,
                                           single_sided=single_sided)
    # env samples use a far point (scene.h:386)
    target = mathx.muladd(ls.wi, torch.clamp(ls.dist, max=1e6)[..., None],
                          pos)
    shoot = ls.pdf > 0 if active is None else active & (ls.pdf > 0)
    if plain:
        occluded = intersect_bf.test_occlusion_bf(trv.tri_xform, pos, target,
                                                  shoot)
    else:
        occluded = ix.test_occlusion(trv, pos, target, active=shoot,
                                     geom=geom)
    return ls._replace(pdf=torch.where(occluded, INVALID_PDF, ls.pdf))
