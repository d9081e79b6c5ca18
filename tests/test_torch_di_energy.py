"""Where the fused ReSTIR DI frame's energy goes on many_light_scene(16,
80), whose fused frame reads 2.4-2.7 % below PT-direct over 64-96
frames at 128x64.

Stage by stage, on the stage's own inputs (shading points of the
general G-buffer of that scene at 128x64), against the direct light by
quadrature over every light triangle (no visibility):
- the RIS stage (`fused_di.ris_pixels`, the twin of B1's, B7's and B10's
  candidates): its weight over many draws equals the integral of its
  target on Lambertian points within 1 %: the candidates are unbiased;
- the shade (`spatial.spatial_shade_ref`, B2's twin, as the JAX
  package's `_spatial_kernel`): it multiplies the estimate of the
  BSDF with base colour 1 by the albedo. On Lambertian points that is
  the BSDF; on metallic points Fresnel's F0 = mix(0.04, base, metallic)
  and its grazing rise to 1 are scaled by the base colour too, so the
  frame estimates 4-8 % less light there than PT-direct's BSDF: the
  reference's own defect (ROADMAP Queue C). The rest of the frame-level
  gap is the RIS estimate's heavy tail on glossy metal, whose mean over
  64 frames falls short of its expectation.
"""

import pytest
import torch

from restir_tpu_torch import convert
from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
from restir_tpu_torch.models import gbuffer as general_gb
from restir_tpu_torch.ops import bsdf
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.ops.kernels import fused_di, ris_cdf, spatial
from restir_tpu_torch.ops.kernels.fused_di import (
    G_ALB,
    G_METAL,
    G_MTYPE,
    G_ROUGH,
    GB_CH,
    P_LI,
    P_M,
    P_WEIGHT,
    P_WI,
    PT_CH,
)
from restir_tpu_torch.scene.mesh import LAMBERTIAN, METALLIC_WORKFLOW
from restir_tpu_torch.scene.procedural import many_light_scene
from restir_tpu_torch.utils import math as mathx

NQ = 48  # quadrature points a side of each light triangle
W, H = 128, 64


@pytest.fixture(scope="module")
def points():
    arrays, camkw = many_light_scene(16, 80)
    scene = convert.scene_from_numpy(arrays, "cpu")
    cfg = RenderConfig(width=W, height=H, tracer=TracerType.RESTIR_DI,
                       aa_jitter=False, **mat_flags(arrays))
    cam = make_camera(**camkw)
    gbuf, it, mat, d = general_gb.render_gbuffer(scene, cam, cam, cfg, 0)
    wo = -d
    flip = (mat.type != 2) & ((it.norm * wo).sum(-1) < 0)
    norm = torch.where(flip[:, None], -it.norm, it.norm)
    shade = it.valid & (gbuf.prim_id >= 0)
    return scene, it, mat, norm, wo, shade


def _pick(shade, mat, mtype, n, seed):
    idx = torch.nonzero(shade & (mat.type == mtype))[:, 0]
    g = torch.Generator().manual_seed(seed)
    return idx[torch.randperm(idx.numel(), generator=g)[:n]]


def _light_samples(scene, pos):
    """The quadrature's light samples seen from `pos`: NQ x NQ
    area-uniform points on each light triangle -> (light row [n], wi [n,
    3] float32, solid angle of each sample [n] float64: cos_l dA / d^2,
    0 where the light faces away: single-sided lights)."""
    a = (torch.arange(NQ, dtype=torch.float64) + 0.5) / NQ
    su, sv = (t.reshape(-1) for t in torch.meshgrid(a, a, indexing="ij"))
    s = torch.sqrt(su)
    bary = torch.stack([1 - s, s * (1 - sv), s * sv], 1)
    lv = scene.light_verts.double()
    rows, wis, doms = [], [], []
    for li in range(lv.shape[0]):
        y = bary @ lv[li]
        area = 0.5 * torch.linalg.norm(torch.linalg.cross(
            lv[li, 1] - lv[li, 0], lv[li, 2] - lv[li, 0]))
        dv = y - pos.double()
        d2 = (dv * dv).sum(1)
        wi = (dv / d2.sqrt()[:, None]).float()
        cos_l = -(wi * scene.light_normal[li]).sum(1)
        dom = torch.where(cos_l > 1e-6, cos_l.double() * area
                          / bary.shape[0] / d2, 0.0)
        rows.append(torch.full((wi.shape[0],), li))
        wis.append(wi)
        doms.append(dom)
    return torch.cat(rows), torch.cat(wis), torch.cat(doms)


def _quadrature(scene, pos, norm, wo, mat):
    """Per point: the integral over every light triangle of lum(L f cos
    cos_l / d^2) dA (float64 sums; single-sided lights), with the BSDF of
    `mat`."""
    out = torch.zeros(pos.shape[0], dtype=torch.float64)
    for p in range(pos.shape[0]):
        m1 = bsdf.SurfaceMaterial(*(t[p:p + 1] for t in mat))
        li, wi, dom = _light_samples(scene, pos[p])
        n_ = wi.shape[0]
        f = bsdf.eval_bsdf(
            bsdf.SurfaceMaterial(*(t.expand(n_, *t.shape[1:]) for t in m1)),
            norm[p].expand(n_, 3), wo[p].expand(n_, 3), wi)
        cos_x = (wi * norm[p]).sum(1).clamp(min=0)
        val = mathx.luminance(scene.light_radiance[li] * f).double()
        out[p] = float((val * cos_x.double() * dom).sum())
    return out


def _shade(scene, pos, norm, wo, mat, prim):
    """Per point: the light that the fused frame's shade
    (`spatial.spatial_shade_ref`, B2's twin; no spatial reuse, no running
    mean) writes for the quadrature's samples, each given as a reservoir
    of one sample: Li, wi, M = 1 and W = p_hat dw, where p_hat = lum(Li)
    f_lum(base 1) cos is the RIS stage's target (`eval_bsdf_lum`) and dw
    the sample's solid angle. A shade of the true BSDF writes the
    integral of `_quadrature`; the sum of its luminance is returned."""
    pack = ris_cdf.pack_inputs(pos, norm, wo, mat.type, mat.metallic,
                               mat.roughness,
                               torch.ones(pos.shape[0], dtype=torch.bool),
                               prim)
    gb_pts = ris_cdf._gb_view(pack)
    gb_pts[G_ALB:G_ALB + 3] = mat.base_color.T
    out = torch.zeros(pos.shape[0], dtype=torch.float64)
    for p in range(pos.shape[0]):
        li, wi, dom = _light_samples(scene, pos[p])
        n_ = wi.shape[0]
        r = -(-n_ // spatial.TILE) * spatial.TILE
        g = gb_pts[:, p:p + 1].expand(GB_CH, r).contiguous()
        f_lum = fused_di.eval_bsdf_lum(
            g[G_MTYPE, :n_], g[G_METAL, :n_], g[G_ROUGH, :n_],
            tuple(norm[p].expand(n_, 3).T), tuple(wo[p].expand(n_, 3).T),
            tuple(wi.T))
        rad = scene.light_radiance[li]
        p_hat = (mathx.luminance(rad) * f_lum
                 * (wi * norm[p]).sum(1).clamp(min=0))
        pt = torch.zeros((PT_CH, r), dtype=torch.float32)
        pt[P_LI:P_LI + 3, :n_] = rad.T
        pt[P_WI:P_WI + 3, :n_] = wi.T
        pt[P_WEIGHT, :n_] = (p_hat.double() * dom).float()
        pt[P_M, :n_] = 1.0
        accum = torch.zeros((3, r), dtype=torch.float32)
        offs = spatial.spatial_offsets(0, r, W, 5, 5.0, "cpu")
        spatial.spatial_shade_ref(offs, g, pt, accum, 0, 0, width=W,
                                  height=H, accumulate=False,
                                  reuse_spatial=False, has_met=True)
        out[p] = float(mathx.luminance(accum.T).double().sum())
    return out


def test_shade_modulation_loses_energy_on_metal(points):
    """The shade on metallic points writes 90-99 % of the light that the
    true BSDF integrates to, and all of it on Lambertian points."""
    scene, it, mat, norm, wo, shade = points
    for mtype, lo, hi in ((LAMBERTIAN, 1 - 1e-5, 1 + 1e-5),
                          (METALLIC_WORKFLOW, 0.90, 0.99)):
        idx = _pick(shade, mat, mtype, 12, 1)
        m = bsdf.SurfaceMaterial(*(t[idx] for t in mat))
        true = _quadrature(scene, it.pos[idx], norm[idx], wo[idx], m)
        got = _shade(scene, it.pos[idx], norm[idx], wo[idx], m,
                     it.prim_id[idx])
        ratio = float(got.sum() / true.sum())
        assert lo < ratio < hi, (mtype, ratio)
        # the shade never writes more light than the true BSDF gives
        assert bool((got <= true * (1 + 1e-5)).all())


def test_ris_stage_is_unbiased_on_lambertian_points(points):
    """E[W] of the RIS stage (`ris_pixels`' weight over its K candidates)
    equals the integral of its target, lum(L) f(base 1) cos G, within 1 %
    over 24 points and 8192 draws each."""
    scene, it, mat, norm, wo, shade = points
    idx = _pick(shade, mat, LAMBERTIAN, 24, 2)
    m = bsdf.SurfaceMaterial(*(t[idx] for t in mat))
    want = _quadrature(scene, it.pos[idx], norm[idx], wo[idx],
                       m._replace(base_color=torch.ones_like(m.base_color)))
    k, reps, loops = 4, 1024, 8
    pack = ris_cdf.pack_inputs(it.pos[idx], norm[idx], wo[idx], m.type,
                               m.metallic, m.roughness,
                               torch.ones(idx.numel(), dtype=torch.bool),
                               it.prim_id[idx])
    gb = ris_cdf._gb_view(pack).repeat(1, reps)
    pix = torch.arange(gb.shape[1])
    est = torch.zeros(idx.numel(), dtype=torch.float64)
    for looper in range(loops):
        _, _, _, w = fused_di.ris_pixels(gb, pix, looper, scene.tables, k=k,
                                         single_sided=True, has_met=True)
        est += (w / k).double().reshape(reps, -1).sum(0)
    est /= reps * loops
    assert abs(float(est.sum() / want.sum()) - 1.0) < 0.01
