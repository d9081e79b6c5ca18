"""Headless CLI of the port, as `restir_tpu.app`: renders N frames on the
card, reports fps / Mrays/s, writes the image (PNG, PFM, HDR or JPEG) and
optionally checkpoints the full renderer state, in the format either
package reads.

Usage:
    python -m restir_tpu_torch SCENE_FILE [options]
    python -m restir_tpu_torch --builtin cornell [options]

It renders only on a CUDA card; `main(argv, device="cpu")` runs the same
steps on the CPU (the plain twins of the kernels) for tests.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import DenoiserType, ReuseMode, ToneMapping, TracerType

TRACERS = {
    "restir_di": TracerType.RESTIR_DI, "pt_direct": TracerType.PT_DIRECT,
    "pt_full": TracerType.PT_FULL, "restir_gi": TracerType.RESTIR_GI,
    "pt_indirect": TracerType.PT_INDIRECT,
    "bvh": TracerType.BVH_VISUALIZE, "gbuffer": TracerType.GBUFFER_PREVIEW,
}
REUSE = {
    "none": ReuseMode.NONE, "temporal": ReuseMode.TEMPORAL,
    "spatial": ReuseMode.SPATIAL, "spatiotemporal": ReuseMode.SPATIOTEMPORAL,
}
DENOISERS = {"none": DenoiserType.NONE, "eaw": DenoiserType.EAW,
             "svgf": DenoiserType.SVGF}
TONEMAPS = {"none": ToneMapping.NONE, "filmic": ToneMapping.FILMIC,
            "aces": ToneMapping.ACES}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="restir_tpu_torch", description=__doc__)
    p.add_argument("scene", nargs="?", help="scene text file (reference format)")
    p.add_argument("--builtin", choices=["cornell", "cornell_metal", "many_light"],
                   help="use a built-in procedural scene")
    p.add_argument("--tracer", default="restir_di",
                   choices=["restir_di", "pt_direct", "pt_indirect", "pt_full",
                            "restir_gi", "bvh", "gbuffer"])
    p.add_argument("--reuse", default="spatiotemporal",
                   choices=["none", "temporal", "spatial", "spatiotemporal"])
    p.add_argument("--denoiser", default="none", choices=["none", "eaw", "svgf"])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--depth", type=int, default=None, help="trace depth")
    p.add_argument("--no-accumulate", action="store_true")
    p.add_argument("--animate-radius", type=float, default=0.0,
                   help="circular camera animation radius (main.cpp:149-153)")
    p.add_argument("--animate-speed", type=float, default=1.0)
    p.add_argument("--tonemap", default="aces", choices=["none", "filmic", "aces"])
    p.add_argument("-o", "--output", default=None, help="output PNG path")
    p.add_argument("--save-state", default=None, help="checkpoint path (.npz)")
    p.add_argument("--load-state", default=None, help="resume from checkpoint")
    p.add_argument("--stats-json", action="store_true",
                   help="print a machine-readable stats line")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="start the interactive browser viewer instead of "
                        "rendering to a file")
    p.add_argument("--dof", action="store_true",
                   help="enable thin-lens depth of field (needs a scene "
                        "camera with LensRadius > 0)")
    p.add_argument("--sampler", default="pcg4d", choices=["pcg4d", "sobol"])
    p.add_argument("--debug-nans", action="store_true",
                   help="check every frame for NaN / Inf and raise "
                        "FloatingPointError naming the frame")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timing JSON after rendering")
    p.add_argument("--rmse-vs-pt", type=int, default=None, metavar="N",
                   help="render an N-frame unbiased NEE reference and "
                        "report RMSE against it (parity harness)")
    return p


def frame_hwc(frame: torch.Tensor, cfg) -> np.ndarray:
    """A general [R, 3] or fused [3, R] frame as numpy [H, W, 3]."""
    if tuple(frame.shape) != (cfg.num_pixels, 3):
        frame = frame.reshape(3, -1).T
    return frame.detach().cpu().numpy().reshape(cfg.height, cfg.width, 3)


def main(argv=None, *, device="cuda") -> int:
    args = build_argparser().parse_args(argv)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("restir_tpu_torch: no CUDA device; the CLI renders "
                         "only on an NVIDIA GPU")
    if not (args.scene or args.builtin):
        build_argparser().error("need a scene file or --builtin")

    from . import convert, renderer
    from .config import RenderConfig, mat_flags
    from .ops import camera as cam_ops
    from .utils.image_io import mirror_for_save, write_png
    from .utils.math import has_nan_or_inf

    tracer = TRACERS[args.tracer]

    # ---- scene (host arrays, then their tensors on the device)
    trace_depth = 5
    image_name = "render"
    if args.scene:
        from .scene.loader import parse_scene_file

        sf = parse_scene_file(args.scene)
        arrays = sf.build()
        cam = sf.make_camera()
        width, height = sf.resolution
        trace_depth = sf.trace_depth
        image_name = sf.image_name
        has_env = sf.env_map is not None
        with_textures = len(sf.textures) > 0
    else:
        from .scene import procedural

        if args.builtin == "cornell":
            arrays, camkw = procedural.cornell_box()
        elif args.builtin == "cornell_metal":
            arrays, camkw = procedural.cornell_box(
                block_materials=("metal", "glass"))
        else:
            arrays, camkw = procedural.many_light_scene()
        cam = cam_ops.make_camera(**camkw)
        width, height = 800, 800
        has_env = False
        with_textures = False
    scene = convert.scene_from_numpy(arrays, dev)

    cfg = RenderConfig(
        width=args.width or width,
        height=args.height or height,
        tracer=tracer,
        trace_depth=args.depth or trace_depth,
        reuse=REUSE[args.reuse],
        denoiser=DENOISERS[args.denoiser],
        tone_mapping=TONEMAPS[args.tonemap],
        accumulate=not args.no_accumulate,
        enable_dof=args.dof,
        sampler=args.sampler,
        has_env_map=has_env,
        with_textures=with_textures,
    )
    # material-set specialization: drop BSDF chains the scene never uses
    cfg = cfg.replace(**mat_flags(arrays))

    if args.serve is not None:
        from .viewer import serve

        serve(scene, cfg, cam, port=args.serve, device=dev)
        return 0

    state = renderer.init_state(cfg, cam, scene, device=dev)
    if args.load_state:
        state = renderer.load_checkpoint(args.load_state, cfg, cam, scene,
                                         device=dev)

    base_pos = np.asarray(cam.position)

    def camera_at(i):
        if args.animate_radius <= 0:
            return cam
        t = i * args.animate_speed * 0.1
        pos = cam_ops.animate_position(base_pos, np.float32(t),
                                       args.animate_radius)
        return cam_ops.update_camera(cam, position=pos)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(state, c, i):
        state, frame = renderer.step(scene, state, c, cfg)
        if args.debug_nans and bool(has_nan_or_inf(frame).any()):
            raise FloatingPointError(f"frame {i} has NaN / Inf values")
        return state, frame

    # warm-up frame: builds the kernels on first use
    t_compile = time.perf_counter()
    state, frame = step(state, camera_at(0), 0)
    sync()
    compile_s = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    for f in range(1, args.frames):
        c = camera_at(f)
        if args.animate_radius > 0:
            # camera moved: restart the running average (main.cpp:158-162)
            state = renderer.reset_iteration(state)
        state, frame = step(state, c, f)
    sync()
    dt = time.perf_counter() - t0
    fps = max(args.frames - 1, 1) / max(dt, 1e-9)

    rmse_vs_pt = None
    if args.rmse_vs_pt:
        # parity harness: unbiased NEE ground truth at high spp
        # (PTDirectKernel is the reference's own A/B target,
        # main.cpp:166-173)
        ref_cfg = cfg.replace(tracer=TracerType.PT_DIRECT,
                              denoiser=DenoiserType.NONE, accumulate=True)
        ref_state = renderer.init_state(ref_cfg, cam, scene, device=dev)
        for _ in range(args.rmse_vs_pt):
            ref_state, ref_frame = renderer.step(scene, ref_state, cam,
                                                 ref_cfg)
        # compare in a common [H, W, 3] layout: the fused path yields
        # channel-major [3, R] frames, PT_DIRECT yields [R, 3]
        ref = frame_hwc(ref_frame, cfg)
        got = frame_hwc(frame, cfg)
        rmse_vs_pt = float(np.sqrt(((got - ref) ** 2).mean()))

    if args.profile:
        # per-stage times between synchronizations (the reference's only
        # profiling is an ImGui fps readout, preview.cpp:221)
        from .models import gbuffer as gbuf_mod

        prof = {}
        gbuf_mod.render_gbuffer(scene, cam, cam, cfg, 0)
        sync()
        t = time.perf_counter()
        for _ in range(4):
            gbuf_mod.render_gbuffer(scene, cam, cam, cfg, 0)
        sync()
        prof["gbuffer_ms"] = round((time.perf_counter() - t) / 4 * 1000, 2)
        t = time.perf_counter()
        for _ in range(4):
            state, frame = renderer.step(scene, state, cam, cfg)
        sync()
        prof["frame_ms"] = round((time.perf_counter() - t) / 4 * 1000, 2)
        print(json.dumps(prof))

    # >= 3 traversals per pixel per ReSTIR frame (primary + shadow winner
    # + temporal/spatial are gathers); report primary+shadow rays
    rays_per_frame = cfg.num_pixels * (2 if tracer == TracerType.RESTIR_DI
                                       else 1)
    mrays = rays_per_frame * fps / 1e6

    out = args.output or f"{image_name}.png"
    img = renderer.frame_to_image(frame, cfg).cpu().numpy()
    ext = out.lower().rsplit(".", 1)[-1]
    if ext in ("jpg", "jpeg"):  # saveImage 'J' key path (main.cpp:121-129)
        from PIL import Image

        Image.fromarray(mirror_for_save(img)).save(out, quality=95)
    elif ext == "pfm":  # HDR float dump
        from .utils.image_io import write_pfm

        write_pfm(out, mirror_for_save(frame_hwc(frame, cfg)))
    elif ext == "hdr":  # Radiance RGBE (Image::saveHDR, image.cpp:70-82)
        from .utils.image_io import write_hdr

        write_hdr(out, mirror_for_save(frame_hwc(frame, cfg)))
    else:
        write_png(out, mirror_for_save(img))

    if args.save_state:
        renderer.save_checkpoint(args.save_state, state)

    stats = {
        "fps": round(fps, 3),
        "mrays_per_s": round(mrays, 3),
        "compile_s": round(compile_s, 3),
        "frames": args.frames,
        "resolution": [cfg.width, cfg.height],
        "output": out,
    }
    if rmse_vs_pt is not None:
        stats["rmse_vs_pt"] = round(rmse_vs_pt, 6)
    if args.stats_json:
        print(json.dumps(stats))
    else:
        print(
            f"[{cfg.width}x{cfg.height} {args.tracer}] {args.frames} frames: "
            f"{fps:.2f} fps ({mrays:.1f} Mrays/s primary+shadow), "
            f"compile {compile_s:.1f}s -> {out}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
