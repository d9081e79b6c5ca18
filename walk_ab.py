"""B13's and B14's walks on the hall at 1920x1080, beyond kernel_ab.py's
per-kernel times:

    python3 walk_ab.py order
    python3 walk_ab.py query
    python3 walk_ab.py busy _chip/parent . . _chip/parent

`order` times B13's any hit on the hall's NEE segments and its primary
hit on the first bounce rays (with the mask of live lanes) when the
batch is permuted into sorted orders (Morton codes of the origin and the
target cell, a quantised direction), in ray order, against the
unsorted batch: what ray coherence is worth to these walks. Each sorted
run must write the unsorted run's bits, permuted; torch.argsort's time
on the keys is printed beside it (the sort is not part of the port).

`query` times B13's closest hit (the ray query, `mt_closest_cuda`) on
the hall's first-bounce rays (every lane, and with the mask of live
lanes) and camera rays: the whole call and its pieces (ray key, radix
sort, the walk through the permutation), the walk in ray order without
a sort, the sort in 4 passes beside 3, and B13's primary hit on the
live first-bounce rays on 8x4-pixel warps beside it; then the sorted
walk against the walk in ray order on the first `n` bounce rays for
growing n (where a sort starts to pay). The call must write the twin's
bits, and the walk in ray order the call's. Device ms a
call (its kernels summed in a torch.profiler trace, least of 3
interleaved rounds of 5 calls), CUDA-event ms beside it; the walk's
registers (ptxas) and its loops' SASS per box step (`cuobjdump`).

`busy` runs each checkout given (the one here, or an unpacked `git
archive` of another commit) in its own process, in the order given:
hall PT-direct, hall general DI + SVGF ("bvh") and the hall heatmap,
chip_smoke.py phase 21's main paths, 2 warm-up + 8 timed frames each,
and the headline SVGF frame (phase 7's main path, 8 + 32 frames), each
then a torch.profiler trace of 4 frames: wall and device busy per
frame.

The rays are kernel_ab.general_rays' (chip_smoke.py phase 19's). Needs
one CUDA card; exits non-zero without one. Prints the card's name and
power limit last.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings


def _order() -> None:
    import torch

    import chip_smoke as cs
    from restir_tpu_torch import convert
    from restir_tpu_torch.ops.kernels import intersect as hits

    dev = torch.device("cuda", 0)
    cs.phase_build()
    _, arrays, cam = cs.load_hall()
    hall = convert.scene_from_numpy(arrays, dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        g = cs.general_rays(hall, cam, dev)
    trv = g["trv"]
    lo = torch.as_tensor(arrays.bounds_lo[0], device=dev).float()
    hi = torch.as_tensor(arrays.bounds_hi[0], device=dev).float()
    last = torch.iinfo(torch.long).max

    def morton(p, bits):
        """Morton code of points p [R, 3] in the scene's box."""
        q = ((p - lo) / (hi - lo)).clamp(0, 1 - 1e-7) * (1 << bits)
        q = q.nan_to_num(0).long()
        code = torch.zeros(p.shape[0], dtype=torch.long, device=dev)
        for b in range(bits):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        return code

    def direction(d, bits=4):
        u = ((d.nan_to_num(0) + 1) / 2).clamp(0, 1 - 1e-7) * (1 << bits)
        u = u.long()
        return (u[:, 0] << (2 * bits)) | (u[:, 1] << bits) | u[:, 2]

    def best_ms(fn):
        return min(cs.cuda_ms(fn, 20) for _ in range(2))

    def run(what, keys, live, inputs, call, permute):
        base = call(*inputs, live)
        for name, key in keys.items():
            if key is None:
                perm, sort_ms = torch.arange(live.shape[0], device=dev), 0.0
            else:
                key = torch.where(live, key, last)
                perm = torch.argsort(key)
                sort_ms = best_ms(lambda: torch.argsort(key))
            args = [t[perm].contiguous() for t in inputs] + [live[perm]]
            if not torch.equal(call(*args), permute(base, perm)):
                raise SystemExit(f"{what} in {name} order: other bits")
            ms = best_ms(lambda: call(*args))
            print(f"{what} in {name} order: {ms:.4f} ms (argsort of the "
                  f"keys {sort_ms:.4f} ms)")

    pos, target = g["pos"], g["target"]
    seg = target - pos
    seg = seg / seg.norm(dim=1, keepdim=True)
    run("B13 any hit, NEE segments", {
        "ray": None,
        "origin": morton(pos, 10),
        "target cell, then origin": morton(target, 6) * (1 << 30)
        + morton(pos, 10),
        "direction, then origin": direction(seg) * (1 << 30)
        + morton(pos, 10),
    }, g["shoot"], [pos, target],
        lambda x, y, a: hits.mt_any_cuda(trv, x, y, a),
        lambda out, perm: out[perm])
    ro, rd = g["ro"], g["rd"]
    run("B13 primary hit, first-bounce rays", {
        "ray": None,
        "origin, then direction": morton(ro, 8) * (1 << 12) + direction(rd),
        "direction, then origin": direction(rd) * (1 << 30)
        + morton(ro, 10),
    }, g["bounce_live"], [ro, rd],
        lambda o, d, a: hits.mt_primary_cuda(trv, hall.prim_attr,
                                             hall.mat_attr, o, d, a),
        lambda out, perm: out[:, perm])


def _query() -> None:
    import torch

    import chip_smoke as cs
    from restir_tpu_torch import convert
    from restir_tpu_torch.ops import intersect
    from restir_tpu_torch.ops.kernels import intersect as hits
    from restir_tpu_torch.ops.kernels import ray_order
    from restir_tpu_torch.prof import _timing

    dev = torch.device("cuda", 0)
    cs.phase_build()
    _, arrays, cam = cs.load_hall()
    hall = convert.scene_from_numpy(arrays, dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        g = cs.general_rays(hall, cam, dev)
    trv = g["trv"]
    rows = trv.walk.rows
    print(f"ptxas intersect.cu mt_closest_kernel: "
          f"{cs.ptxas_report('intersect.cu', 'mt_closest_kernel')}")

    def bits(out):
        return [t.contiguous().view(torch.int32) if t.is_floating_point()
                else t for t in out]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))

    def report(what, fns):
        t = _timing.interleaved(fns, dev, rounds=3)
        for name, v in t.items():
            print(f"query {what} {name}: {min(v.device):.4f} ms device "
                  f"(events {min(v.events):.4f})", flush=True)
        return {k: min(v.device) for k, v in t.items()}

    batches = (("first-bounce rays", g["ro"], g["rd"], None),
               ("first-bounce rays, live lanes", g["ro"], g["rd"],
                g["bounce_live"]),
               ("camera rays", g["o"], g["d"], None))
    for what, o, d, act in batches:
        want = intersect.intersect_closest_bvh(trv.walk, o, d, act)
        got = hits.mt_closest_cuda(trv, o, d, act)
        if not same(got, want):
            raise SystemExit(f"query {what}: not the twin's bits")
        *_, counts = hits.mt_closest_cuda(trv, o, d, act, stats=True)
        boxes = float(counts[0].double().sum())
        tris = float(counts[1].double().sum())
        key = ray_order.ray_key(o, d, act, rows)
        perm = ray_order.radix_sort(key, ray_order.RAY_SORT_PASSES)[1]
        if not same(hits.mt_closest_walk(trv, o, d, act), got):
            raise SystemExit(f"query {what}: the walk in ray order writes "
                             "other bits")
        fns = {
            "whole call": lambda: hits.mt_closest_cuda(trv, o, d, act),
            "key": lambda: ray_order.ray_key(o, d, act, rows),
            "sort": lambda: ray_order.radix_sort(
                key, ray_order.RAY_SORT_PASSES),
            "sort, 4 passes": lambda: ray_order.radix_sort(
                key, ray_order.SORT_PASSES),
            "walk": lambda: hits.mt_closest_walk(trv, o, d, act, perm),
            "walk, ray order": lambda: hits.mt_closest_walk(trv, o, d, act),
        }
        if act is not None:
            fns["B13 primary hit, 8x4 tiles"] = lambda: hits.mt_primary_cuda(
                trv, hall.prim_attr, hall.mat_attr, o, d, act,
                geom=(cs.WIDTH, 0))
        print(f"query {what}: {boxes / o.shape[0]:.2f} box and "
              f"{tris / o.shape[0]:.2f} triangle tests a ray; bound "
              f"{cs.bound(0, boxes * cs.FLOP_BOX + tris * cs.FLOP_MT)[0]:.4f}"
              f" ms (operations)", flush=True)
        report(what, fns)
        if act is None and what.startswith("first"):
            cs.walk_sass_report("B13 closest", "mt_closest_kernel", boxes,
                                lambda: hits.mt_closest_walk(trv, o, d,
                                                             None, perm))
    o, d = g["ro"], g["rd"]
    for n in (32, 64, 128, 256, 512, 1024, 4096):
        on, dn = o[:n].contiguous(), d[:n].contiguous()
        report(f"first {n} bounce rays", {
            "sorted": lambda: hits.mt_closest_walk(
                trv, on, dn, None,
                ray_order.radix_sort(ray_order.ray_key(on, dn, None, rows),
                                     ray_order.RAY_SORT_PASSES)[1]),
            "ray order": lambda: hits.mt_closest_walk(trv, on, dn)})


def _busy() -> None:
    import inspect

    import torch

    import chip_smoke as cs
    from restir_tpu_torch import convert
    from restir_tpu_torch.config import (
        DenoiserType,
        RenderConfig,
        TracerType,
        mat_flags,
    )
    from restir_tpu_torch.ops.camera import make_camera
    from restir_tpu_torch.ops.kernels import svgf
    from restir_tpu_torch.scene.procedural import many_light_scene

    dev = torch.device("cuda", 0)
    cs.phase_build()
    _, arrays, cam = cs.load_hall()
    hall = convert.scene_from_numpy(arrays, dev)
    base = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                        **mat_flags(arrays))
    levels = base.eaw_levels
    # the variance and level 0's prefilter are one launch since the
    # variance redesign
    fused = "moments" in inspect.signature(svgf.estimate_variance).parameters
    n_var = levels if fused else 1 + levels
    for name, cfg, per_frame in (
            ("hall PT-direct", base.replace(tracer=TracerType.PT_DIRECT),
             {"mt_primary": 2, "mt_any": 1}),
            ("hall general DI + SVGF",
             base.replace(tracer=TracerType.RESTIR_DI, intersector="bvh",
                          ris_mode="cdf", denoiser=DenoiserType.SVGF),
             {"mt_primary": 1, "ris_cdf": 1, "ris_search": 1,
              "svgf_variance": n_var,
              "atrous_svgf": levels}),
            ("hall heatmap", base.replace(tracer=TracerType.BVH_VISUALIZE),
             {"heatmap": 1, "mt_primary": 1})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # auto's notice: the walk
            cs.phase_general_main(name, hall, cfg, cam, dev, per_frame,
                                  cs.GENERAL_WARMUP, cs.GENERAL_TIMED)
            cs.profile_frames(name, hall, cfg, cam, dev)
    h_arrays, camkw = many_light_scene(64, 24)
    scene = convert.scene_from_numpy(h_arrays, dev)
    cfg = cs.render_config(h_arrays, denoiser=DenoiserType.SVGF)
    h_cam = make_camera(**camkw)
    cs.phase_main("headline SVGF", scene, cfg, h_cam, dev, {
        "fused_di": 2, "spatial": 1, "svgf_temporal": 1,
        "svgf_variance": n_var, "atrous_svgf": levels})
    cs.profile_frames("headline SVGF", scene, cfg, h_cam, dev)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("walk_ab: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["order"]:
        _order()
    elif argv[:1] == ["query"]:
        _query()
    elif argv[:1] == ["busy"] and argv[1:]:
        for tree in argv[1:]:
            root = os.path.abspath(tree)
            print(f"checkout {tree}", flush=True)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child"],
                cwd=root, env={**os.environ, "PYTHONPATH": root},
                capture_output=True, text=True, timeout=1200)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith(("main path", "profile"))]
            print("\n".join(lines), flush=True)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
    elif argv == ["--child"]:
        sys.path.insert(0, os.getcwd())
        _busy()
        return 0
    else:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs

    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
