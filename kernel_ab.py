"""Time kernels B1, B1b, B2, B3, B4, B5, B6, B7, B8, B9, B10, B11, B12, B13
and B14 and the probe kernels P1, P2, P3, P4, P5 and P14 of several
checkouts of restir_tpu_torch on one card, in turns, and check which
write the same packs.

    python3 kernel_ab.py _chip/parent . . _chip/parent

Each argument is the root of a checkout (the one here, or an unpacked
`git archive` of another commit). Each runs in a process of its own, in
the order given, with its root first on the module path, so each builds
and loads its own kernels. A run times, by CUDA events at 1920x1080
(mean over 20 launches after 4 warm-up launches):
- B1 (`fused_di.di_resident_cuda`: launch a, then B1b) on frame 1 of the
  headline scene (many_light_scene(64, 24)) with live history, and on
  env_scene() (has_env_map) and textured_scene(aux_maps=True)
  (with_textures), as chip_smoke.py phases 3 and 8 call it;
- B8 (`gi.gi_trace_cuda`, depth 5) on B1's G-buffer of the headline scene
  and of cornell_box(), as chip_smoke.py phase 15 calls it, and B9
  (`gi.gi_resolve_cuda`) on each B8 pack, with that frame's own resolve
  at looper 0 as the previous pack;
- B12 (`intersect.primary_cuda`) on the headline's 1080p camera rays and
  on the rays of PT-full's first bounce from their hits (every lane, and
  where the tree's B12 takes a mask, the live lanes only), B11's closest
  hit (`closest_cuda`) on those bounce rays and its any hit (`any_cuda`)
  on NEE segments from the camera hits (`general_rays`, built from the
  plain twin so every tree gets the same rays), as chip_smoke.py phase
  12 calls them;
- B10 (`ris_cdf.ris_cdf_cuda`) on the general G-buffer pack of the
  headline scene and of the hall (`b10_input`, which chip_smoke.py's
  phases 12, 27 and 29 also call; a tree whose B10 takes no MTBVH is
  called without one);
- B3 (`atrous.atrous_level_cuda`), levels 0-4 in turn, each on the last
  level's output, from the headline frame's demodulated colour (B1, then
  B2 on a seeded accumulator), as chip_smoke.py phase 3 calls it; and B4
  (`atrous.atrous_svgf_cuda`), levels 0-4, on SVGF's inputs (B5 on a
  seeded history, the variance kernels) as phase 7 calls it, and the
  variance kernels themselves: the variance with level 0's prefilter
  (one kernel where the tree fuses them, else the estimate and a
  prefilter) and the prefilter of levels 1-4, each on B4's variance; B2
  (`spatial.spatial_shade_cuda`, in place on a seeded accumulator) and
  B5 (`svgf.svgf_temporal_cuda`) themselves on those inputs;
- B6 and B7 (`gbuffer_cuda`, `candidates_cuda`) on the headline frame,
  and on scenes/hall.txt (81,036 triangles) and the same hall under a
  code-made sky (512 env tiles), frame 1 from chip_smoke.py phase 9's
  moved camera: the main paths on which B6 and B7 run (B7 on 2-D pixel
  tiles where the tree's B7 takes the frame's width), and B1b
  (`fused_di.temporal_cuda`) after B7 on the hall and the sky hall, with
  frame 0's pack from the unmoved camera as history;
- the light tables past a block's shared memory, where the tree renders
  them: B7's streamed build forced (`_streamed=True`, in a tree with two
  builds) beside each B7 call above (the headline, the hall and the sky
  hall), and B7
  (on frame 1's G-buffer) and B10 (on the general G-buffer) of
  many_light_scene(1225, 24) and (5000, 24) (2,450 and 10,000 light
  rows), as chip_smoke.py phase 29 builds them, with the device time of
  the light search kernel and of each walk apart where the tree
  launches them apart;
- B13 and B14 on the hall's 1080p rays (`general_rays` on the hall, as
  chip_smoke.py phase 19 builds them; "auto" takes the MTBVH walk
  there): B13's primary hit (`mt_primary_cuda`) on the camera rays and,
  with the mask of live lanes, on the first bounce rays; its any hit
  (`mt_any_cuda`) on the NEE segments with their live lanes; its closest
  hit (`mt_closest_cuda`) on the bounce rays (every lane and the live
  lanes) and on the camera rays, and where the tree sorts the ray query,
  its pieces alone (ray key, radix sort, the walk through the
  permutation) on the same batches; B14 (`heatmap_cuda`) on the
  camera rays and on the pixel-centre rays the heatmap casts. The
  primary and any hit and B14 get the batch's geometry (the whole
  frame), as the render paths pass it, where the tree's kernel takes
  one; a tree whose kernel takes none is called without it;
- the ray-order probe kernels (`restir_tpu_torch/prof/kernels.py`) on
  the hall's 1080p NEE segments (`prof_take.inputs`): the coherence key
  (direction, then origin), the radix sort of it, the [9, R] segment
  pack's permuted gather and its copy floor, the scatter of B13's flags
  back to pixel order (the tree's `scatter_cols` where it has one, else
  the indexed store its wavefront probe ran); B13's any hit in pixel
  order and, in each key order, `prof_wavefront`'s sorted path whole
  (key, sort, gather, walk, scatter) and step by step
  (`sorted_pieces`), every input warm in L2 from the calls before;
- the brute-force any hit (`prof_fma`'s 1920 x 1080 random rays in the
  headline scene's box against its 512 padded plane rows) in its three
  forms: FP32 (P2), 3xTF32 and 6xTF32 on the tensor cores (P1); and the
  table gathers (P3) from shared memory, through __ldg and from a
  texture at K = 1024 and 8192 (R = 1920 x 1088, index (i * 7919) % K),
  beside index_select, each call on the next of 8 copies of the index
  so that index and output are cold in L2 (the shared form and
  index_select also warm, on one index); the vec3 chains (P5) in their
  three layouts (SoA, float3 AoS, float4; `prof_v3`'s 1920 x 1080 pack,
  laid out once, as `prof_v3.run` does). The tensor-core forms sum in
  another order than an earlier build's, so their flags are compared ray
  by ray: this script prints, per form, the rays whose flag differs from
  the first run's, and per chain layout the output values whose bits
  differ from the first run's.
It prints one JSON line (card, ms, the device ms of each call's
kernels from a torch.profiler trace of 20 more calls, and the SHA-256 of
each kernel's output packs). The device ms is the kernel's time where
it is shorter than its wrapper's host time, which the CUDA events then
measure (the SVGF variance kernels). This script then prints, per
kernel, the ms and device ms of every run and which runs wrote the same
packs (runs marked with one letter agree),
then the card's name and power limit. Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

WIDTH, HEIGHT = 1920, 1080
REPS = 20
WARMUP = 3


def general_rays(scene, cam, dev, width=WIDTH, height=HEIGHT):
    """The general path's rays (1080p by default) on a scene, from the
    plain B12 twin's hits of frame 1's camera rays: a dict of the
    traversal arrays `trv`, camera rays `o`, `d` and their pack `pack`;
    PT-full's first bounce rays `ro`, `rd` (make_offseted_ray of a BSDF
    sample) and its live lanes `bounce_live`; NEE segments `pos` ->
    `target` with their live lanes `shoot`."""
    import torch

    from restir_tpu_torch.config import RenderConfig, TracerType
    from restir_tpu_torch.models import gbuffer as general_gb
    from restir_tpu_torch.ops import bsdf, intersect, lights
    from restir_tpu_torch.ops.kernels import intersect as hits
    from restir_tpu_torch.scene.mesh import DIELECTRIC, LIGHT
    from restir_tpu_torch.utils import rng

    cfg = RenderConfig(width=width, height=height, tracer=TracerType.PT_FULL)
    trv = intersect.traversal_arrays(scene)
    _, o, d = general_gb.primary_rays(cam, cfg, 1, rng.SALT_CAMERA, dev)
    o, d = o.contiguous(), d.contiguous()
    pack = hits.primary_ref(trv, scene.prim_attr, scene.mat_attr, o, d)
    prim, _, _, pos, norm, _, matp = hits.unpack_primary(pack)
    mat = bsdf.SurfaceMaterial(
        type=matp[:, 0].to(torch.int32), base_color=matp[:, 1:4],
        metallic=matp[:, 4], roughness=matp[:, 5], ior=matp[:, 6])
    live = (prim >= 0) & (mat.type != LIGHT)
    wo = -d
    flip = (mat.type != DIELECTRIC) & ((norm * wo).sum(-1) < 0)
    norm = torch.where(flip[:, None], -norm, norm)
    pix = torch.arange(o.shape[0], device=dev)
    bs = bsdf.sample_bsdf(mat, norm, wo,
                          rng.uniform4(pix, 1, 2, rng.SALT_PT)[:3])
    ro, rd = intersect.make_offseted_ray(pos, bs.wi)
    l1, l2, l3, l4 = rng.uniform4(pix, 1, 1, rng.SALT_PT)
    ls = lights.sample_direct_light_no_visibility(scene, pos, l1, l2, l3, l4,
                                                  has_env=False)
    target = pos + ls.wi * torch.clamp(ls.dist, max=1e6)[:, None]
    return dict(trv=trv, o=o, d=d, pack=pack, ro=ro.contiguous(),
                rd=rd.contiguous(),
                bounce_live=live & ~bsdf.is_invalid(bs.type)
                & (bs.pdf >= 1e-8),
                pos=pos.contiguous(), target=target.contiguous(),
                shoot=live & (ls.pdf > 0))


def b10_input(scene, cam, dev, width=WIDTH, height=HEIGHT):
    """B10's input pack on the general G-buffer of frame 1 (1080p by
    default; the shading normal faces wo unless dielectric) and its
    shading lanes: the pack this script times and chip_smoke.py's phases
    12, 27 and 29 check."""
    import torch

    from restir_tpu_torch.config import RenderConfig, TracerType
    from restir_tpu_torch.models import gbuffer as general_gb
    from restir_tpu_torch.ops.kernels import ris_cdf
    from restir_tpu_torch.scene.mesh import DIELECTRIC

    cfg = RenderConfig(width=width, height=height,
                       tracer=TracerType.RESTIR_DI)
    gbuf, it, gmat, ray_dir = general_gb.render_gbuffer(scene, cam, cam, cfg,
                                                        1)
    wo = -ray_dir
    flip = (gmat.type != DIELECTRIC) & ((it.norm * wo).sum(-1) < 0)
    shade = it.valid & (gbuf.prim_id != general_gb.LIGHT_ID)
    pack = ris_cdf.pack_inputs(
        it.pos, torch.where(flip[:, None], -it.norm, it.norm), wo,
        gmat.type, gmat.metallic, gmat.roughness, shade, it.prim_id)
    return pack, shade


def _child() -> None:
    # the checkout under test, ahead of this script's own directory
    sys.path.insert(0, os.getcwd())
    import inspect
    import itertools

    import numpy as np
    import torch

    from restir_tpu_torch import convert
    from restir_tpu_torch.config import RenderConfig, TracerType, mat_flags
    from restir_tpu_torch.models import restir_di_fused, restir_gi
    from restir_tpu_torch.ops.camera import make_camera, pack_camera
    from restir_tpu_torch.ops.kernels import (
        atrous,
        fused_di,
        gbuffer,
        gi,
        reuse,
        ris_cdf,
        spatial,
        svgf,
    )
    from restir_tpu_torch.ops.kernels import intersect as hits
    from restir_tpu_torch.scene.loader import parse_scene_file
    from restir_tpu_torch.scene.procedural import (
        cornell_box,
        env_scene,
        gradient_sky,
        many_light_scene,
        textured_scene,
    )

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = torch.device("cuda", 0)
    ms, sha, dev_ms = {}, {}, {}

    def device_ms(fn, tries=3, by_name=None):
        """Mean device time of fn's kernels per call, from a
        torch.profiler trace of REPS calls; a trace that lost kernels
        (their count is no multiple of REPS) is taken again, up to
        `tries` times, then nan. by_name: a dict that receives the device
        time per call of each kernel name."""
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                fn()
                torch.cuda.synchronize()
                prof.step()
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            us = [e.time_range.elapsed_us() for e in evs]
            if us and len(us) % REPS == 0:
                for e in evs if by_name is not None else ():
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.time_range.elapsed_us() / REPS
                                       / 1e3)
                return sum(us) / REPS / 1e3
        return float("nan")
    # B7 takes the frame's width (2-D pixel tiles) since its search redesign
    b7_tiles = ({"width": WIDTH} if "width" in inspect.signature(
        reuse.candidates_cuda).parameters else {})
    # a tree with two B7 builds forces its streamed one with
    # `_streamed=True` on tables that fit the staged one
    forced = ({"_streamed": True} if "_streamed" in inspect.signature(
        reuse.candidates_cuda).parameters else None)
    # B1's wrapper takes the scene's MTBVH since the walk redesign
    takes_bvh = "bvh" in inspect.signature(
        fused_di.di_resident_cuda).parameters

    def di_resident(cam_vec, lcam_vec, looper, prev_pt, scene, **kw):
        bvh = (scene.bvh,) if takes_bvh else ()
        return fused_di.di_resident_cuda(cam_vec, lcam_vec, looper, prev_pt,
                                         scene.tables, *bvh, **kw)

    def timed(name, fn, parts=None):
        """parts: {label: kernel name part}: also the device ms of those
        kernels of the call alone, as "<name>: <label>"."""
        out = fn()
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.detach().cpu().numpy().tobytes())
        sha[name] = h.hexdigest()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / REPS
        by_name = {}
        dev_ms[name] = device_ms(fn, by_name=by_name)
        for label, part in (parts or {}).items():
            dev_ms[f"{name}: {label}"] = ms[f"{name}: {label}"] = sum(
                v for k, v in by_name.items() if part in k)

    def b13(hall, cam):
        """B13 and B14 on the hall (chip_smoke.py phase 19)."""
        import warnings

        # B13's primary and any hit take the batch's geometry since their
        # 8x4-pixel warps
        geom = ({"geom": (WIDTH, 0)} if "geom" in inspect.signature(
            hits.mt_primary_cuda).parameters else {})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # auto's notice: the walk
            g = general_rays(hall, cam, dev)
        trv, attr, mats = g["trv"], hall.prim_attr, hall.mat_attr
        timed("B13 primary hall camera rays", lambda: hits.mt_primary_cuda(
            trv, attr, mats, g["o"], g["d"], **geom))
        timed("B13 primary hall bounce rays, live lanes",
              lambda: hits.mt_primary_cuda(trv, attr, mats, g["ro"],
                                           g["rd"], g["bounce_live"],
                                           **geom))
        timed("B13 any hall NEE segments", lambda: hits.mt_any_cuda(
            trv, g["pos"], g["target"], g["shoot"], **geom))
        timed("B13 closest hall bounce rays", lambda: hits.mt_closest_cuda(
            trv, g["ro"], g["rd"]))
        timed("B13 closest hall bounce rays, live lanes",
              lambda: hits.mt_closest_cuda(trv, g["ro"], g["rd"],
                                           g["bounce_live"]))
        timed("B13 closest hall camera rays", lambda: hits.mt_closest_cuda(
            trv, g["o"], g["d"]))
        # the sorted ray query's pieces, where the tree has them
        if hasattr(hits, "mt_closest_walk"):
            from restir_tpu_torch.ops.kernels import ray_order

            for what, o, d, act in (
                    ("bounce rays", g["ro"], g["rd"], None),
                    ("bounce rays, live lanes", g["ro"], g["rd"],
                     g["bounce_live"]),
                    ("camera rays", g["o"], g["d"], None)):
                key = ray_order.ray_key(o, d, act, trv.walk.rows)
                passes = ray_order.RAY_SORT_PASSES
                perm = ray_order.radix_sort(key, passes)[1]
                timed(f"B13 closest {what}: key", lambda: ray_order.ray_key(
                    o, d, act, trv.walk.rows))
                timed(f"B13 closest {what}: sort",
                      lambda: ray_order.radix_sort(key, passes))
                timed(f"B13 closest {what}: walk",
                      lambda: hits.mt_closest_walk(trv, o, d, act, perm))
        # B14 takes the batch's geometry since its 8x4-pixel warps; the
        # heatmap casts pixel-centre rays
        from restir_tpu_torch.ops.camera import pixel_centers, sample_rays

        x, y = pixel_centers(WIDTH, HEIGHT, dev)
        half = torch.full_like(x, 0.5)
        ho, hd = (t.contiguous() for t in sample_rays(
            cam, WIDTH, HEIGHT, x, y, half, half))
        geom14 = ({"geom": (WIDTH, 0)} if "geom" in inspect.signature(
            hits.heatmap_cuda).parameters else {})
        timed("B14 hall camera rays", lambda: hits.heatmap_cuda(
            trv, g["o"], g["d"], **geom14))
        timed("B14 hall pixel-centre rays", lambda: hits.heatmap_cuda(
            trv, ho, hd, **geom14))

    def b1(name, arrays, cam, cam2, **flags):
        scene = convert.scene_from_numpy(arrays, dev)
        cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                           tracer=TracerType.RESTIR_DI, **mat_flags(arrays))
        cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
        kw = dict(width=WIDTH, height=HEIGHT, aa_jitter=cfg.aa_jitter,
                  single_sided=cfg.single_sided_lights,
                  k=cfg.cdf_candidates, temporal=True,
                  temporal_clamp=cfg.temporal_clamp,
                  has_met=cfg.scene_has_metallic, **flags)
        zeros = torch.zeros((fused_di.PT_CH, WIDTH * HEIGHT), device=dev)
        _, pt0 = di_resident(cv, cv, 0, zeros, scene, **kw)
        timed(name, lambda: di_resident(cv2, cv, 1, pt0, scene, **kw))
        return scene, cfg, cv, cv2, pt0, kw

    arrays, camkw = many_light_scene(64, 24)
    cam = make_camera(**camkw)
    cam2 = make_camera(position=(0.25, 4.5, 15.0),
                       rotation=(-90.5, -10.0, 0.0), fov_y=30.0)
    scene, cfg, cv, cv2, pt0, kw = b1("B1 headline", arrays, cam, cam2)
    gb_k, pt_k = di_resident(cv2, cv, 1, pt0, scene, **kw)
    r = WIDTH * HEIGHT
    offs = spatial.spatial_offsets(1, r, WIDTH, cfg.spatial_neighbors,
                                   cfg.spatial_radius, dev)
    acc0 = torch.as_tensor(
        np.random.default_rng(0).random((3, r), dtype=np.float32), device=dev)
    b2kw = dict(width=WIDTH, height=HEIGHT, neighbors=cfg.spatial_neighbors,
                has_met=cfg.scene_has_metallic)
    scratch = acc0.clone()
    timed("B2 headline", lambda: spatial.spatial_shade_cuda(
        offs, gb_k, pt_k, scratch, 1, 3, **b2kw))
    acc = spatial.spatial_shade_cuda(offs, gb_k, pt_k, acc0, 1, 3, **b2kw)
    alb = torch.clamp(gb_k[fused_di.G_ALB:fused_di.G_ALB + 3], min=0.0)
    color = acc / torch.where(alb > 1e-4, alb, 1.0)
    akw = dict(width=WIDTH, height=HEIGHT, sig_l=cfg.sig_luminance,
               sig_n=cfg.sig_normal, sig_d=cfg.sig_depth)
    for level in range(cfg.eaw_levels):
        c_in = color
        timed(f"B3 level {level}", lambda: atrous.atrous_level_cuda(
            c_in, gb_k, level=level, **akw))
        color = atrous.atrous_level_cuda(c_in, gb_k, level=level, **akw)
    g5 = np.random.default_rng(5)
    prev = torch.as_tensor(g5.random((svgf.SV_CH, r), dtype=np.float32),
                           device=dev)
    prev[svgf.SV_HIST] = torch.as_tensor(
        g5.integers(0, 8, r).astype(np.float32), device=dev)
    prev[svgf.SV_PRIM] = gb_k[fused_di.G_PRIMR]
    prev[svgf.SV_NORM:svgf.SV_NORM + 3] = gb_k[fused_di.G_NORM:
                                               fused_di.G_NORM + 3]
    color5 = torch.as_tensor(g5.random((3, r), dtype=np.float32),
                             device=dev)
    timed("B5 headline", lambda: svgf.svgf_temporal_cuda(gb_k, color5,
                                                          prev))
    sv = svgf.svgf_temporal_cuda(gb_k, color5, prev)
    vkw = dict(width=WIDTH, height=HEIGHT)
    col = sv[svgf.SV_COL:svgf.SV_COL + 3].contiguous()
    # the variance and level 0's prefilter: one kernel on the pack's
    # moment rows since the variance redesign, an estimate on the pack
    # and a prefilter before it
    if "moments" in inspect.signature(svgf.estimate_variance).parameters:
        def var_pair():
            return svgf.estimate_variance(
                sv[svgf.SV_M1:svgf.SV_M1 + 3], **vkw)
    else:
        def var_pair():
            v = svgf.estimate_variance(sv, **vkw)
            return v, svgf.filter_variance(v, **vkw)
    timed("SVGF variance + level-0 prefilter", var_pair)
    var, fv = var_pair()
    skw = dict(width=WIDTH, height=HEIGHT, sig_l=cfg.sig_luminance,
               sig_n=cfg.svgf_sig_normal, sig_d=cfg.svgf_sig_depth)
    for level in range(cfg.eaw_levels):
        if level > 0:
            v_in = var
            timed(f"SVGF prefilter level {level}",
                  lambda: svgf.filter_variance(v_in, **vkw))
            fv = svgf.filter_variance(var, **vkw)
        c_in, v_in = col, var
        timed(f"B4 level {level}", lambda: atrous.atrous_svgf_cuda(
            c_in, v_in, fv, gb_k, level=level, **skw))
        col, var = atrous.atrous_svgf_cuda(c_in, v_in, fv, gb_k, level=level,
                                           **skw)
    del gb_k, pt_k, acc, color, prev, sv, col, var, fv
    gb = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, width=WIDTH,
                              height=HEIGHT)
    timed("B6 headline", lambda: gbuffer.gbuffer_cuda(
        cv2, cv, 1, scene.bvh, width=WIDTH, height=HEIGHT))
    timed("B7 headline", lambda: reuse.candidates_cuda(
        gb, 1, scene.tables, scene.bvh, k=cfg.cdf_candidates,
        has_met=cfg.scene_has_metallic, **b7_tiles))
    if forced is not None:
        timed("B7 headline, streamed build forced", lambda: (
            reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                  k=cfg.cdf_candidates,
                                  has_met=cfg.scene_has_metallic,
                                  **b7_tiles, **forced)))
    g = general_rays(scene, cam, dev)
    trv, attr, mats = g["trv"], scene.prim_attr, scene.mat_attr
    timed("B12 camera rays", lambda: hits.primary_cuda(
        trv, attr, mats, g["o"], g["d"]))
    timed("B12 bounce rays", lambda: hits.primary_cuda(
        trv, attr, mats, g["ro"], g["rd"]))
    # B12 takes a mask of live lanes since the walk redesign
    if "active" in inspect.signature(hits.primary_cuda).parameters:
        timed("B12 bounce rays, live lanes", lambda: hits.primary_cuda(
            trv, attr, mats, g["ro"], g["rd"], g["bounce_live"]))
    timed("B11 closest bounce rays", lambda: hits.closest_cuda(
        trv, g["ro"], g["rd"]))
    timed("B11 any NEE segments", lambda: hits.any_cuda(
        trv, g["pos"], g["target"], g["shoot"]))
    # B10 on the general G-buffer; it takes the MTBVH since its walk
    dcfg = RenderConfig(width=WIDTH, height=HEIGHT,
                        tracer=TracerType.RESTIR_DI)
    pack, _ = b10_input(scene, cam, dev)
    b10_bvh = ((scene.bvh,) if "bvh" in inspect.signature(
        ris_cdf.ris_cdf_cuda).parameters else ())
    b10_kw = dict(k=dcfg.cdf_candidates,
                  single_sided=dcfg.single_sided_lights,
                  has_met=dcfg.scene_has_metallic)
    timed("B10 general G-buffer", lambda: ris_cdf.ris_cdf_cuda(
        pack, 1, scene.tables, *b10_bvh, **b10_kw))
    del pack
    del g, trv
    for name, (sc_arrays, sc_kw), flags in (
            ("B1 env", env_scene(), dict(has_env=True)),
            ("B1 textures", textured_scene(aux_maps=True),
             dict(with_textures=True))):
        pos = sc_kw["position"]
        b1(name, sc_arrays, make_camera(**sc_kw),
           make_camera(**{**sc_kw, "position": (pos[0] + 0.25, pos[1],
                                                pos[2])}), **flags)

    for name, (gi_arrays, gi_kw) in (
            ("B8 GI headline", (arrays, camkw)),
            ("B8 GI cornell", cornell_box())):
        scene = convert.scene_from_numpy(gi_arrays, dev)
        cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                           tracer=TracerType.RESTIR_GI,
                           **mat_flags(gi_arrays))
        cv = pack_camera(make_camera(**gi_kw), dev)
        gb, _ = di_resident(
            cv, cv, 1, torch.zeros((fused_di.PT_CH, WIDTH * HEIGHT),
                                   device=dev), scene, width=WIDTH,
            height=HEIGHT, aa_jitter=cfg.aa_jitter,
            has_met=cfg.scene_has_metallic)
        in_pack, gq = restir_di_fused.gi_packs(scene, gb)
        kw = restir_gi.trace_kwargs(scene, cfg)
        timed(name, lambda: gi.gi_trace_cuda(in_pack, 1, scene, **kw))
        # B9 on B8's pack, the previous pack its own frame-0 resolve
        go = gi.gi_trace_cuda(in_pack, 1, scene, **kw)
        q0 = gi.gi_resolve_cuda(go, in_pack, gq, torch.zeros(
            (gi.Q_CH, WIDTH * HEIGHT), device=dev), 0)[1]
        timed(name.replace("B8", "B9"), lambda: gi.gi_resolve_cuda(
            go, in_pack, gq, q0, 1))

    # the hall, then the hall under a sky (chip_smoke.py phases 9 and 11)
    sys.path.insert(0, os.path.join(os.getcwd(), "scenes"))
    from make_hall import ensure_assets

    ensure_assets()
    sf = parse_scene_file(os.path.join(os.getcwd(), "scenes", "hall.txt"))
    cv = pack_camera(sf.make_camera(), dev)
    cv2 = pack_camera(make_camera(position=(0.3, 4.2, 20.3),
                                  rotation=(-90.5, -4.0, 0.0), fov_y=19.5),
                      dev)
    for name, sky in (("hall", False), ("sky hall", True)):
        if sky:
            sf.env_map = gradient_sky(512, 1024)
        hall_arrays = sf.build()
        scene = convert.scene_from_numpy(hall_arrays, dev)
        cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                           tracer=TracerType.RESTIR_DI, has_env_map=sky,
                           **mat_flags(hall_arrays))
        gkw = dict(width=WIDTH, height=HEIGHT, aa_jitter=cfg.aa_jitter,
                   single_sided=cfg.single_sided_lights, has_env=sky)
        gb = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, **gkw)
        timed(f"B6 {name}", lambda: gbuffer.gbuffer_cuda(
            cv2, cv, 1, scene.bvh, **gkw))
        ckw = dict(k=cfg.cdf_candidates, single_sided=cfg.single_sided_lights,
                   has_met=cfg.scene_has_metallic, has_env=sky, **b7_tiles)
        timed(f"B7 {name}", lambda: reuse.candidates_cuda(
            gb, 1, scene.tables, scene.bvh, **ckw))
        if forced is not None:
            timed(f"B7 {name}, streamed build forced", lambda: (
                reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh, **ckw,
                                      **forced)))
        # B1b after B7, on frame 0's pack from the unmoved camera
        gb0 = gbuffer.gbuffer_cuda(cv, cv, 0, scene.bvh, **gkw)
        pt0 = fused_di.temporal_cuda(
            gb0, reuse.candidates_cuda(gb0, 0, scene.tables, scene.bvh,
                                       **ckw),
            torch.zeros((fused_di.PT_CH, WIDTH * HEIGHT), device=dev), 0,
            k=cfg.cdf_candidates)
        rs = reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh, **ckw)
        timed(f"B1b {name}", lambda: fused_di.temporal_cuda(
            gb, rs, pt0, 1, k=cfg.cdf_candidates,
            temporal_clamp=cfg.temporal_clamp))
        del gb, gb0, pt0, rs
        if not sky:
            # B10 on the hall's general G-buffer (no env rows)
            pack, _ = b10_input(scene, sf.make_camera(), dev)
            timed("B10 hall", lambda: ris_cdf.ris_cdf_cuda(
                pack, 1, scene.tables, *b10_bvh, **b10_kw))
            del pack
            b13(scene, sf.make_camera())
        del scene

    # B7 and B10 past the tables their first designs staged, where the
    # tree renders them (a tree that stages its tables whole refuses
    # these with ValueError), on many_light_scene(1225, 24) and (5000,
    # 24): 2,450 and 10,000 light rows, as chip_smoke.py phase 29 builds
    # their inputs
    for n_quads in (1225, 5000):
        ml_arrays, ml_kw = many_light_scene(n_quads, 24)
        scene = convert.scene_from_numpy(ml_arrays, dev)
        cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                           tracer=TracerType.RESTIR_DI,
                           **mat_flags(ml_arrays))
        pos = ml_kw["position"]
        cv = pack_camera(make_camera(**ml_kw), dev)
        cv2 = pack_camera(make_camera(**{**ml_kw, "position": (
            pos[0] + 0.25, pos[1], pos[2])}), dev)
        gb = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, width=WIDTH,
                                  height=HEIGHT)
        rows = 2 * n_quads
        try:
            reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                  k=cfg.cdf_candidates, **b7_tiles)
        except ValueError as e:
            print(f"{rows} light rows: B7 refuses them ({e})")
            break
        # the light search and each walk alone, where the tree
        # launches them apart
        timed(f"B7 streamed, {rows} light rows", lambda: (
            reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                  k=cfg.cdf_candidates,
                                  has_met=cfg.scene_has_metallic,
                                  width=WIDTH)),
              {"search": "ris_search_kernel",
               "walk": "reuse_walk_kernel"})
        pack, _ = b10_input(scene, make_camera(**ml_kw), dev)
        timed(f"B10, {rows} light rows", lambda: (
            ris_cdf.ris_cdf_cuda(pack, 1, scene.tables, scene.bvh,
                                 k=cfg.cdf_candidates,
                                 has_met=cfg.scene_has_metallic)),
              {"search": "ris_search_kernel", "walk": "ris_cdf_kernel"})
        del scene, gb, pack

    def ray_order():
        """The ray-order probe kernels on the hall's NEE segments."""
        from restir_tpu_torch.prof import _scenes, prof_take, prof_wavefront
        from restir_tpu_torch.prof import kernels as pk

        fr, trv, pos, target, live, key, perm = prof_take.inputs(dev, False)
        lo, hi = _scenes.scene_box(fr)
        pack = prof_take.segment_pack(pos, target, live)
        pl = perm.long()
        geom = {"geom": (fr.cfg.width, 0)}
        flags = hits.any_hit(trv, pos, target, live, **geom)
        sf = flags[pl].contiguous()

        def scatter():
            if hasattr(pk, "scatter_cols"):
                return pk.scatter_cols(sf, perm)
            out = torch.empty_like(sf)
            out[pl] = sf
            return out

        order = "direction_origin"
        timed("P14 key", lambda: pk.coherence_key(pos, target, live, lo, hi,
                                                  order))
        timed("P14 sort", lambda: pk.radix_sort(key))
        timed("P4 gather [9, R]", lambda: pk.gather_cols(pack, perm))
        timed("P4 copy", lambda: pk.copy_pack(pack))
        timed("P4 scatter of B13's flags", scatter)
        timed("B13 any hall NEE segments, pixel order", lambda: hits.any_hit(
            trv, pos, target, live, **geom))
        for o in pk.KEY_ORDERS:
            steps, whole = prof_wavefront.sorted_pieces(trv, pos, target,
                                                        live, lo, hi, o)
            if not torch.equal(whole(), flags):
                raise RuntimeError(f"sorted B13 in {o} order differs from "
                                   "the pixel order's flags")
            timed(f"wavefront {o}", whole)
            for step, fn in steps.items():
                timed(f"wavefront {o}.{step}", fn)

    def probes():
        """P1 / P2's any hit, P5's chains and P3's table gathers
        (`prof_fma`, `prof_v3`, `prof_gather`); the any hit's flags and
        the chains' outputs saved for `main`."""
        from restir_tpu_torch.ops import intersect
        from restir_tpu_torch.prof import _scenes, prof_fma
        from restir_tpu_torch.prof import kernels as pk

        fr = _scenes.headline(dev)
        xform = intersect.traversal_arrays(fr.scene, "brute").tri_xform
        planes = pk.plane_rows(xform, prof_fma.N_PAD)
        rays = prof_fma.random_rays(*_scenes.scene_box(fr), WIDTH * HEIGHT,
                                    dev)
        flags = {}
        for f in pk.ANYHIT_FORMS:
            name = f"{'P2' if f == 'fma' else 'P1'} any hit {f}"
            timed(name, lambda f=f: pk.anyhit(rays, planes, f))
            flags[name] = np.packbits(pk.anyhit(rays, planes, f).cpu()
                                      .numpy())
        # P5: the chains on inputs laid out once (prof_v3.run), their
        # outputs saved beside the flags
        from restir_tpu_torch.prof import prof_v3

        cpack = prof_v3.pack(WIDTH * HEIGHT, dev)
        laid = {c: pk.chain_inputs(cpack, c) for c in pk.CHAIN_LAYOUTS}
        for c in pk.CHAIN_LAYOUTS:
            name = f"P5 chain {c}"
            timed(name, lambda c=c: pk.chain_laid(laid[c], c))
            flags[name] = pk.chain_laid(laid[c], c).cpu().numpy()
        del cpack, laid
        if os.environ.get("KERNEL_AB_FLAGS"):
            np.savez(os.environ["KERNEL_AB_FLAGS"], **flags)
        def cold(fn, ix, sets=8):
            """fn on the next of `sets` copies of the index, each output
            kept until its copy comes round again: index and output cold
            in L2 (prof_gather.cold, which an earlier tree may lack)."""
            copies = [ix.clone() for _ in range(sets)]
            kept = [None] * sets
            turn = itertools.count()

            def call():
                i = next(turn) % sets
                kept[i] = None
                kept[i] = fn(copies[i])
                return kept[i]

            return call

        for k in (1024, 8192):
            table = torch.arange(k, dtype=torch.float32, device=dev) * 0.5
            idx = pk.gather_index(1920 * 1088, k, dev)
            idx_l = idx.long()
            tex = pk.texture(table)
            for w in pk.GATHER_WHERE:
                timed(f"P3 gather K{k} {w}", cold(
                    lambda ix, w=w: pk.table_gather(table, ix, w, tex=tex),
                    idx))
            timed(f"P3 gather K{k} index_select",
                  cold(lambda ix: table.index_select(0, ix), idx_l))
            # the same calls with index and output warm in L2
            timed(f"P3 gather K{k} shared, warm",
                  lambda: pk.table_gather(table, idx, "shared"))
            timed(f"P3 gather K{k} index_select, warm",
                  lambda: table.index_select(0, idx_l))
            torch.cuda.synchronize()
            pk.free_texture(tex)

    ray_order()
    probes()
    import restir_tpu_torch

    print(json.dumps({
        "root": os.path.dirname(os.path.dirname(restir_tpu_torch.__file__)),
        "card": torch.cuda.get_device_name(0), "ms": ms,
        "device_ms": dev_ms, "sha256": sha}))


def main(trees) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import tempfile

    import numpy as np

    runs = []
    flag_dir = tempfile.TemporaryDirectory()
    for tree in trees:
        root = os.path.abspath(tree)
        env = {**os.environ, "PYTHONPATH": root,
               "KERNEL_AB_FLAGS": os.path.join(flag_dir.name,
                                               f"run{len(runs)}.npz")}
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"run {len(runs) + 1}: {tree}: {json.dumps(res)}")
        if res["root"] != root:
            print(f"kernel_ab: run {len(runs) + 1} imported "
                  f"{res['root']}, not {root}", file=sys.stderr)
            return 1
        runs.append(res)
    names = list(dict.fromkeys(n for r in runs for n in r["ms"]))
    for name in names:
        times = ", ".join(f"{r['ms'][name]:.4f}" if name in r["ms"] else "-"
                          for r in runs)
        dtimes = ", ".join(f"{r['device_ms'][name]:.4f}"
                           if name in r.get("device_ms", {}) else "-"
                           for r in runs)
        letters = {}
        marks = "".join(
            letters.setdefault(r["sha256"][name], "ABCDEFGH"[len(letters)])
            if name in r["sha256"] else "-" for r in runs)
        same = ("identical in every run" if len(letters) == 1
                else f"by run {marks}")
        print(f"{name}: ms by run [{times}], device ms [{dtimes}] "
              f"({' / '.join(trees)}); " + (
                  f"packs {same}" if letters else
                  "device ms of those kernels of the call above"))
    flags = [np.load(os.path.join(flag_dir.name, f"run{i}.npz"))
             for i in range(len(runs))]
    for name in flags[0].files:
        if flags[0][name].dtype == np.float32:  # a chain's output values
            first = flags[0][name].view(np.uint32)
            diff = [int((f[name].view(np.uint32) != first).sum())
                    if name in f.files else -1 for f in flags]
            print(f"{name}: values whose bits differ from run 1's, by run "
                  f"{diff} of {first.size}")
            continue
        first = np.unpackbits(flags[0][name])
        diff = [int((np.unpackbits(f[name]) != first).sum())
                if name in f.files else -1 for f in flags]
        print(f"{name}: rays whose flag differs from run 1's, by run "
              f"{diff} of {first.size}")
    flag_dir.cleanup()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        sys.exit(main(sys.argv[1:] or ["."]))
