"""BSDF models, as `restir_tpu.ops.bsdf` (material.h:34-256): Lambertian,
metallic-workflow GGX with VNDF sampling, and dielectric. Every lobe is
evaluated and the material type selects per lane, as the JAX package
does; material parameters arrive per lane (already textured)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.mesh import DIELECTRIC, LAMBERTIAN, METALLIC_WORKFLOW
from ..utils import math as mathx

# BSDFSampleType flags — material.h:16-25
DIFFUSE = 1 << 0
GLOSSY = 1 << 1
SPECULAR = 1 << 2
REFLECTION = 1 << 4
TRANSMISSION = 1 << 5
INVALID = 1 << 15


class SurfaceMaterial(NamedTuple):
    type: torch.Tensor  # [R] int32
    base_color: torch.Tensor  # [R, 3]
    metallic: torch.Tensor  # [R]
    roughness: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # [R, 3]
    f: torch.Tensor  # [R, 3]
    pdf: torch.Tensor  # [R]
    type: torch.Tensor  # [R] int32 flags


def _v(x):
    return x[..., None]


def fresnel_schlick(cos_theta, f0):
    # mix(f0, 1, t) = f0 (1 - t) + t (the compiled JAX code drops the 1 *)
    t = _v(mathx.pow5(1.0 - cos_theta))
    return mathx.muladd(f0, 1.0 - t, t)


def fresnel_dielectric(cos_in, ior):
    """Exact dielectric Fresnel — material.h:43-60."""
    ior = torch.where(cos_in < 0, 1.0 / ior, ior)
    cos_in = torch.abs(cos_in)
    sin_in = torch.sqrt(torch.clamp(mathx.muladd(-cos_in, cos_in, 1.0),
                                    min=0.0))
    sin_tr = sin_in / ior
    tir = sin_tr >= 1.0
    cos_tr = torch.sqrt(torch.clamp(mathx.muladd(-sin_tr, sin_tr, 1.0),
                                    min=0.0))
    rs = mathx.square(mathx.muladd(-ior, cos_tr, cos_in)
                      / torch.clamp(mathx.muladd(ior, cos_tr, cos_in),
                                    min=1e-20))
    rp = mathx.square(mathx.muladd(ior, cos_in, -cos_tr)
                      / torch.clamp(mathx.muladd(ior, cos_in, cos_tr),
                                    min=1e-20))
    return torch.where(tir, 1.0, (rs + rp) * 0.5)


def schlick_g(cos_theta, alpha):
    a = alpha * 0.5
    return cos_theta / torch.clamp(mathx.muladd(cos_theta, 1.0 - a, a),
                                   min=1e-20)


def smith_g(cos_wo, cos_wi, alpha):
    return (schlick_g(torch.abs(cos_wo), alpha)
            * schlick_g(torch.abs(cos_wi), alpha))


def gtr2_distrib(cos_theta, alpha):
    aa = alpha * alpha
    denom = mathx.muladd(cos_theta * cos_theta, aa - 1.0, 1.0)
    denom = denom * denom * mathx.PI
    return torch.where(cos_theta < 1e-6, 0.0,
                       aa / torch.clamp(denom, min=1e-20))


def gtr2_pdf(n, m, wo, alpha):
    """VNDF pdf — material.h:82-85."""
    return (gtr2_distrib(mathx.dot(n, m), alpha)
            * schlick_g(mathx.dot(n, wo), alpha)
            * mathx.abs_dot(m, wo)
            / torch.clamp(mathx.abs_dot(n, wo), min=1e-20))


def gtr2_sample_vndf(n, wo, alpha, rx, ry):
    """Visible-normal GGX sampling (Heitz 2018) — material.h:94-111."""
    t, b = mathx.local_ref_frame(n)
    lx = mathx.dot(wo, t)
    ly = mathx.dot(wo, b)
    lz = mathx.dot(wo, n)
    vh = mathx.safe_normalize(torch.stack([lx * alpha, ly * alpha, lz],
                                          dim=-1))
    len_sq = mathx.muladd(vh[..., 0], vh[..., 0], vh[..., 1] * vh[..., 1])
    t1 = torch.where(
        _v(len_sq > 0),
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(len_sq)],
                    dim=-1)
        / _v(torch.sqrt(torch.clamp(len_sq, min=1e-20))),
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device))
    t2 = mathx.cross(vh, t1)
    p = mathx.to_concentric_disk(rx, ry)
    s = 0.5 * (vh[..., 2] + 1.0)
    px = p[..., 0]
    py = mathx.muladd(
        1.0 - s, torch.sqrt(torch.clamp(mathx.muladd(-px, px, 1.0),
                                        min=0.0)), s * p[..., 1])
    pz = torch.sqrt(torch.clamp(
        mathx.muladd(-py, py, mathx.muladd(-px, px, 1.0)), min=0.0))
    h = mathx.weighted3(t1, _v(px), t2, _v(py), vh, _v(pz))
    h = torch.stack([h[..., 0] * alpha, h[..., 1] * alpha,
                     torch.clamp(h[..., 2], min=0.0)], dim=-1)
    return mathx.safe_normalize(mathx.weighted3(t, h[..., 0:1], b,
                                                h[..., 1:2], n, h[..., 2:3]))


def _lambertian_eval(mat, n, wo, wi):
    return mat.base_color * mathx.INV_PI


def _lambertian_pdf(mat, n, wo, wi):
    return mathx.sat_dot(n, wi) * mathx.INV_PI


def _metallic_eval(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = mathx.safe_normalize(wo + wi)
    cos_o = mathx.dot(n, wo)
    cos_i = mathx.dot(n, wi)
    valid = cos_i * cos_o >= 1e-7
    f0 = mathx.mix(torch.full_like(mat.base_color, 0.08), mat.base_color,
                   _v(mat.metallic))
    f = fresnel_schlick(mathx.dot(h, wo), f0)
    g = smith_g(cos_o, cos_i, alpha)
    d = gtr2_distrib(mathx.dot(n, h), alpha)
    spec = _v(g * d / torch.clamp(4.0 * cos_i * cos_o, min=1e-20))
    diffuse = mat.base_color * mathx.INV_PI * _v(1.0 - mat.metallic)
    return torch.where(_v(valid), mathx.mix(diffuse, spec, f), 0.0)


def _metallic_pdf(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = mathx.safe_normalize(wo + wi)
    spec_pdf = gtr2_pdf(n, h, wo, alpha) / torch.clamp(
        4.0 * mathx.abs_dot(h, wo), min=1e-20)
    diff_pdf = mathx.sat_dot(n, wi) * mathx.INV_PI
    return mathx.mix(diff_pdf, spec_pdf, 1.0 / (2.0 - mat.metallic))


def eval_bsdf(mat: SurfaceMaterial, n, wo, wi):
    """f(wo, wi) — Material::BSDF (material.h:218-228); delta lobes 0."""
    t = _v(mat.type)
    return torch.where(t == LAMBERTIAN, _lambertian_eval(mat, n, wo, wi),
                       torch.where(t == METALLIC_WORKFLOW,
                                   _metallic_eval(mat, n, wo, wi), 0.0))


def eval_bsdf_lum(mat: SurfaceMaterial, n, wo, wi):
    """Luminance of f(wo, wi): with the demodulated material (base
    colour 1) every lobe is grey, so this is the BSDF."""
    return mathx.luminance(eval_bsdf(mat, n, wo, wi))


def pdf_bsdf(mat: SurfaceMaterial, n, wo, wi):
    """Material::pdf (material.h:230-240)."""
    return torch.where(mat.type == LAMBERTIAN,
                       _lambertian_pdf(mat, n, wo, wi),
                       torch.where(mat.type == METALLIC_WORKFLOW,
                                   _metallic_pdf(mat, n, wo, wi), 0.0))


def sample_bsdf(mat: SurfaceMaterial, n, wo, r3) -> BSDFSample:
    """Material::sample (material.h:242-256): every lobe is sampled and
    the material type picks. r3: (rx, ry, rz) uniforms [R]."""
    rx, ry, rz = r3
    lam_wi = mathx.sample_hemisphere_cosine(n, rx, ry)

    alpha = mat.roughness * mat.roughness
    h = gtr2_sample_vndf(n, wo, alpha, rx, ry)
    refl = mathx.safe_normalize(mathx.muladd(wo, -1.0,
                                             h * _v(2.0 * mathx.dot(wo, h))))
    pick_diffuse = rz > 1.0 / (2.0 - mat.metallic)
    met_wi = torch.where(_v(pick_diffuse), lam_wi, refl)
    met_invalid = mathx.dot(n, met_wi) < 0.0

    cos_wo = mathx.dot(n, wo)
    pdf_refl = fresnel_dielectric(cos_wo, mat.ior)
    refl_dir = mathx.safe_normalize(mathx.muladd(n, _v(2.0 * cos_wo), -wo))
    refract_ok, refr_dir = mathx.refract(n, wo, mat.ior)
    choose_refl = rz < pdf_refl
    die_wi = torch.where(_v(choose_refl), refl_dir, refr_dir)
    eta = torch.where(cos_wo < 0, 1.0 / mat.ior, mat.ior)
    die_f = torch.where(_v(choose_refl), mat.base_color,
                        mat.base_color / _v(eta * eta))
    die_invalid = (~choose_refl) & (~refract_ok)
    die_type = torch.where(
        die_invalid, INVALID,
        torch.where(choose_refl, SPECULAR | REFLECTION,
                    SPECULAR | TRANSMISSION))

    t = mat.type
    lam, met = _v(t == LAMBERTIAN), _v(t == METALLIC_WORKFLOW)
    wi = torch.where(lam, lam_wi, torch.where(met, met_wi, die_wi))
    f = torch.where(lam, _lambertian_eval(mat, n, wo, lam_wi),
                    torch.where(met, _metallic_eval(mat, n, wo, met_wi),
                                die_f))
    pdf = torch.where(t == LAMBERTIAN, _lambertian_pdf(mat, n, wo, lam_wi),
                      torch.where(t == METALLIC_WORKFLOW,
                                  _metallic_pdf(mat, n, wo, met_wi), 1.0))
    type_flags = torch.where(
        t == LAMBERTIAN, DIFFUSE | REFLECTION,
        torch.where(t == METALLIC_WORKFLOW,
                    torch.where(met_invalid, INVALID, GLOSSY | REFLECTION),
                    torch.where(t == DIELECTRIC, die_type, INVALID)),
    ).to(torch.int32)
    return BSDFSample(wi=wi, f=f, pdf=pdf, type=type_flags)


def is_delta(sample_type):
    return (sample_type & SPECULAR) != 0


def is_invalid(sample_type):
    return (sample_type & INVALID) != 0
