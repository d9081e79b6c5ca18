"""The direct light of the ReSTIR DI estimators, frame by frame and
stage by stage, on many_light_scene(16, nb) at 128x64 on the CPU, or on
the hall (scenes/hall.txt) and at other sizes on the card:

    python3 energy.py frames [--nb 80] [--fused 96] [--pt 256] [--jax]
    python3 energy.py frames --device cuda --scene hall --size 384x384 \
        --fused 1024 --pt 1024
    python3 energy.py stages [--nb 80] [--points 120] [--draws 262144]
    python3 energy.py shadow [--nb 80]

`frames`: the mean of `--fused` fused RESTIR_DI frames (reuse NONE, no
denoiser, each frame its own estimate) and of `--pt` PT_DIRECT frames,
each with its standard error over frames, their ratio, and each image's
light by the material of its pixel-centre hit (-1: lights and misses,
0 Lambertian, 1 metallic, 2 dielectric), on `--device` (the port's
plain twins on the CPU, its kernels on a CUDA card); with `--jax`, the
JAX package's frames (its fused kernels in the Pallas interpreter, on
the CPU) in place of the port's.

`stages` (CPU): on `--points` metallic shading points of the
pixel-centre G-buffer, the direct light without visibility by
quadrature over every light triangle, with the BSDF and with the fused
shade's albedo x BSDF(base colour 1), against the mean over `--draws`
draws of the fused RIS stage (`ops.kernels.fused_di.ris_pixels`, B1's /
B7's / B10's twin: its weight over its K candidates) and of PT-direct's
NEE estimate.

`shadow` (CPU): the fused frame's shadow ray (origin offset 1e-5 along
the light, limit dist (1 - 1e-3) - 1e-4, its own triangle excluded)
against PT-direct's occlusion ray (`ops.intersect_bf.occlusion_ray`) on
the same 8 x R NEE segments: how many each finds occluded.

The port's modules run in float32; seeds are fixed, so a run repeats its
numbers on one device. Only `frames --jax` imports the JAX package.
"""

from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

SIZE = "128x64"
NQ = 64  # quadrature points a side of each light triangle


def _size(args):
    w, h = (int(v) for v in args.size.split("x"))
    return w, h


def _port_scene(args, device="cpu"):
    """(arrays, scene tensors on `device`, camera) of args.scene."""
    from restir_tpu_torch import convert
    from restir_tpu_torch.ops.camera import make_camera
    from restir_tpu_torch.scene.procedural import many_light_scene

    if args.scene == "hall":
        from restir_tpu_torch.prof import _scenes

        fr = _scenes.hall(device)
        return fr.arrays, fr.scene, fr.cam
    arrays, camkw = many_light_scene(16, args.nb)
    return arrays, convert.scene_from_numpy(arrays, device), make_camera(
        **camkw)


def _gbuffer(arrays, scene, cam, size):
    """The pixel-centre G-buffer: (it, mat, shading normal, wo, material
    type per pixel with -1 for lights and misses)."""
    from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
    from restir_tpu_torch.models.gbuffer import render_gbuffer

    w, h = size
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       aa_jitter=False, **mat_flags(arrays))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        gb, it, mat, d = render_gbuffer(scene, cam, cam, cfg, 0)
    wo = -d
    flip = (mat.type != 2) & ((it.norm * wo).sum(-1) < 0)
    norm = torch.where(flip[:, None], -it.norm, it.norm)
    typ = torch.where(it.valid & (gb.prim_id >= 0), mat.type.long(), -1)
    return it, mat, norm, wo, typ


def _split(img, typ):
    lum = img.mean(axis=1)
    return {int(t): round(float(lum[typ == t].sum() / lum.size), 6)
            for t in np.unique(typ)}


def frames(args):
    if args.jax and (args.device != "cpu" or args.scene != "many_light"):
        raise SystemExit("--jax runs many_light_scene on the CPU only")
    arrays, scene, cam = _port_scene(args, args.device)
    typ = _gbuffer(arrays, scene, cam, _size(args))[4].cpu().numpy()
    out = {}
    for name, n in (("fused", args.fused), ("PT-direct", args.pt)):
        t0 = time.perf_counter()
        if args.jax:
            img, means = _jax_frames(args, name, n)
        else:
            img, means = _port_frames(args, (arrays, scene, cam), name, n)
        out[name] = float(np.mean(means))
        print(f"{'JAX' if args.jax else 'port'} {name} ({args.scene}"
              f"{'' if args.scene == 'hall' else f'(16, {args.nb})'}, "
              f"{args.size}, {args.device}): {n} frames, mean "
              f"{np.mean(means):.6f} +- {np.std(means, ddof=1) / n ** 0.5:.6f}"
              f", by material {_split(img, typ)} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    print(f"ratio fused / PT-direct {out['fused'] / out['PT-direct']:.4f}")


def _port_frames(args, loaded, name, n):
    from restir_tpu_torch import renderer
    from restir_tpu_torch.config import (DenoiserType, RenderConfig,
                                         ReuseMode, TracerType, mat_flags)

    arrays, scene, cam = loaded
    w, h = _size(args)
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE, reuse=ReuseMode.NONE,
                       accumulate=False, **mat_flags(arrays))
    if name == "PT-direct":
        cfg = cfg.replace(tracer=TracerType.PT_DIRECT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        state = renderer.init_state(cfg, cam, scene, device=args.device)
        acc, means = 0.0, []
        for _ in range(n):
            state, fr = renderer.step(scene, state, cam, cfg)
            f = (fr.T if fr.shape[0] == 3 else fr).double()
            acc = acc + f
            means.append(f.mean())
    return (acc / n).cpu().numpy(), torch.stack(means).cpu().numpy()


def _jax_frames(args, name, n):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from restir_tpu import renderer
    from restir_tpu.config import (DenoiserType, RenderConfig, ReuseMode,
                                   TracerType, mat_flags)
    from restir_tpu.models import restir_di_fused
    from restir_tpu.ops.camera import make_camera
    from restir_tpu.scene.procedural import many_light_scene

    scene, camkw = many_light_scene(16, args.nb, bvh_impl="numpy")
    cam = make_camera(**camkw)
    w, h = _size(args)
    cfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE, reuse=ReuseMode.NONE,
                       accumulate=False, **mat_flags(scene))
    acc, means = 0.0, []
    if name == "fused":
        state = restir_di_fused.init_state(cfg, cam)
        for _ in range(n):
            state, fr = restir_di_fused.step_fused(scene, state, cam, cfg,
                                                   interpret=True)
            f = np.asarray(fr).reshape(3, -1).T.astype(np.float64)
            acc = acc + f
            means.append(f.mean())
    else:
        cfg = cfg.replace(tracer=TracerType.PT_DIRECT)
        state = renderer.init_state(cfg, cam)
        for _ in range(n):
            state, fr = renderer.step_jit(scene, state, cam, cfg)
            f = np.asarray(fr).reshape(-1, 3).astype(np.float64)
            acc = acc + f
            means.append(f.mean())
    return acc / n, means


def _quadrature(scene, pos, norm, wo, mat, modulated):
    """Per point, the integral over every light triangle of lum(L f cos
    cos_l / d^2) dA (single-sided lights), midpoint rule on an
    area-uniform NQ x NQ map; `modulated`: albedo x BSDF(base colour 1)."""
    from restir_tpu_torch.ops import bsdf
    from restir_tpu_torch.utils import math as mathx

    a = (torch.arange(NQ, dtype=torch.float64) + 0.5) / NQ
    su, sv = (t.reshape(-1) for t in torch.meshgrid(a, a, indexing="ij"))
    s = torch.sqrt(su)
    bary = torch.stack([1 - s, s * (1 - sv), s * sv], 1)
    lv = scene.light_verts.double()
    out = np.zeros(pos.shape[0])
    for p in range(pos.shape[0]):
        m1 = bsdf.SurfaceMaterial(*(t[p:p + 1] for t in mat))
        if modulated:
            m1 = m1._replace(base_color=torch.ones_like(m1.base_color))
        for li in range(lv.shape[0]):
            y = bary @ lv[li]
            area = 0.5 * torch.linalg.norm(torch.linalg.cross(
                lv[li, 1] - lv[li, 0], lv[li, 2] - lv[li, 0]))
            dv = y - pos[p].double()
            d2 = (dv * dv).sum(1)
            wi = (dv / d2.sqrt()[:, None]).float()
            cos_x = (wi * norm[p]).sum(1).clamp(min=0)
            cos_l = -(wi * scene.light_normal[li]).sum(1)
            n = wi.shape[0]
            f = bsdf.eval_bsdf(bsdf.SurfaceMaterial(
                *(t.expand(n, *t.shape[1:]) for t in m1)),
                norm[p].expand(n, 3), wo[p].expand(n, 3), wi)
            rad = scene.light_radiance[li] * (mat.base_color[p] if modulated
                                              else 1.0)
            val = mathx.luminance(rad * f).double() * (
                cos_x * cos_l.clamp(min=0)).double() / d2
            out[p] += float(torch.where(cos_l > 1e-6, val, 0.0).sum()
                            * area / n)
    return out


def stages(args):
    from restir_tpu_torch.ops import bsdf, lights
    from restir_tpu_torch.ops.kernels import fused_di, ris_cdf
    from restir_tpu_torch.utils import math as mathx
    from restir_tpu_torch.utils import rng

    arrays, scene, cam = _port_scene(args)
    it, mat, norm, wo, _ = _gbuffer(arrays, scene, cam, _size(args))
    idx = torch.nonzero(it.valid & (mat.type == 1))[:, 0]
    g = torch.Generator().manual_seed(0)
    idx = idx[torch.randperm(idx.numel(), generator=g)[:args.points]]
    m = bsdf.SurfaceMaterial(*(t[idx] for t in mat))
    pos, nrm, w_o = it.pos[idx], norm[idx], wo[idx]
    t0 = time.perf_counter()
    true = _quadrature(scene, pos, nrm, w_o, m, False)
    mod = _quadrature(scene, pos, nrm, w_o, m, True)
    print(f"{idx.numel()} metallic points: quadrature {true.sum():.5f}, "
          f"albedo x BSDF(base 1) {mod.sum():.5f}, ratio "
          f"{mod.sum() / true.sum():.4f} ({time.perf_counter() - t0:.0f} s)",
          flush=True)
    k, reps = 4, max(1, 65536 // idx.numel())
    pack = ris_cdf.pack_inputs(pos, nrm, w_o, m.type, m.metallic,
                               m.roughness,
                               torch.ones(idx.numel(), dtype=torch.bool),
                               it.prim_id[idx])
    gb = ris_cdf._gb_view(pack).repeat(1, reps)
    rep = lambda t: t.repeat((reps,) + (1,) * (t.dim() - 1))  # noqa: E731
    mr = bsdf.SurfaceMaterial(*(rep(t) for t in m))
    pr, nr, wr = rep(pos), rep(nrm), rep(w_o)
    pix = torch.arange(gb.shape[1])
    ris, nee = np.zeros(idx.numel()), np.zeros(idx.numel())
    loops = max(1, args.draws // reps)
    t0 = time.perf_counter()
    for looper in range(loops):
        li, _, _, w = fused_di.ris_pixels(gb, pix, looper, scene.tables,
                                          k=k, single_sided=True,
                                          has_met=True)
        # the fused shade of the winner, in luminance, with the albedo
        # the true BSDF's quadrature is held to: W / K x lum(albedo x Li)
        # / lum(Li)
        li_lum = mathx.luminance(li.T)
        scale = torch.where(li_lum > 0, (w / k) / li_lum.clamp(min=1e-20),
                            0.0)
        ris += (mathx.luminance(li.T * mr.base_color) * scale).double() \
            .reshape(reps, -1).sum(0).numpy()
        u = rng.uniform4(pix, looper, 1, rng.SALT_PT)
        ls = lights.sample_direct_light_no_visibility(scene, pr, *u,
                                                      has_env=False)
        f = bsdf.eval_bsdf(mr, nr, wr, ls.wi)
        c = mathx.luminance(ls.radiance * f) * mathx.sat_dot(nr, ls.wi) \
            / ls.pdf.clamp(min=1e-20)
        c = mathx.zero_nan_or_inf(torch.where(ls.pdf > 0, c, 0.0))
        nee += c.double().reshape(reps, -1).sum(0).numpy()
    n = loops * reps
    print(f"over {n} draws a point ({time.perf_counter() - t0:.0f} s): the "
          f"fused RIS stage with its shade {ris.sum() / n:.5f} (ratio to the "
          f"modulated quadrature {ris.sum() / n / mod.sum():.4f}), "
          f"PT-direct's NEE {nee.sum() / n:.5f} (ratio to the quadrature "
          f"{nee.sum() / n / true.sum():.4f})")


def shadow(args):
    from restir_tpu_torch.ops import intersect as ix
    from restir_tpu_torch.ops import intersect_bf, lights
    from restir_tpu_torch.ops.kernels import fused_di
    from restir_tpu_torch.utils import rng

    arrays, scene, cam = _port_scene(args)
    it, mat, _, _, _ = _gbuffer(arrays, scene, cam, _size(args))
    shade = it.valid & (mat.type != 4) & (mat.type != 2)
    idx = torch.nonzero(shade)[:, 0]
    pos, prim = it.pos[idx], it.prim_id[idx].to(torch.int32)
    xform = ix.traversal_arrays(scene, "brute").tri_xform
    pix = torch.arange(idx.numel())
    n = occ_f = occ_p = both = 0
    for looper in range(8):
        u = rng.uniform4(pix, looper, 1, rng.SALT_PT)
        ls = lights.sample_direct_light_no_visibility(scene, pos, *u,
                                                      has_env=False)
        ok = ls.pdf > 0
        target = pos + ls.wi * ls.dist[:, None]
        p_occ = intersect_bf.test_occlusion_bf(xform, pos, target, ok)
        o = tuple(pos[:, c] + ls.wi[:, c] * 1e-5 for c in range(3))
        limit = ls.dist * (1.0 - 1e-3) - 1e-4
        f_occ = fused_di.occluded_brute(scene.tables.planes, o,
                                        tuple(ls.wi.T), limit, prim) & ok
        n += int(ok.sum())
        occ_f += int(f_occ.sum())
        occ_p += int(p_occ.sum())
        both += int((f_occ & p_occ).sum())
    print(f"{n} segments: occluded by the fused shadow ray {occ_f}, by "
          f"PT-direct's {occ_p}, by both {both}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("frames", "stages", "shadow"))
    ap.add_argument("--scene", choices=("many_light", "hall"),
                    default="many_light")
    ap.add_argument("--nb", type=int, default=80,
                    help="blocks of many_light_scene(16, nb)")
    ap.add_argument("--size", default=SIZE, help="WxH (default %(default)s)")
    ap.add_argument("--device", default="cpu",
                    help="frames only: cpu (the twins) or cuda (the kernels)")
    ap.add_argument("--fused", type=int, default=96)
    ap.add_argument("--pt", type=int, default=256)
    ap.add_argument("--jax", action="store_true",
                    help="the JAX package's frames (frames only)")
    ap.add_argument("--points", type=int, default=120)
    ap.add_argument("--draws", type=int, default=262144)
    args = ap.parse_args(argv)
    {"frames": frames, "stages": stages, "shadow": shadow}[args.what](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
