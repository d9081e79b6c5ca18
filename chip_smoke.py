"""Drive the PyTorch/CUDA port's render paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device check: a CUDA card is required; nothing runs on the CPU;
  2. build: nvcc compiles restir_tpu_torch/csrc (and the stage probes' builds,
     phase 28), one process per source,
     and prints each kernel's registers and spills (ptxas);
  3. headline kernels vs twins: B1 fused DI, B2 spatial + shade, B3 EAW
     level against their plain PyTorch twins on the card at the headline
     shapes (1920x1080, many_light_scene(64, 24)), on a frame with live
     temporal history; kernel and twin times by CUDA events; B1's packs
     (env and texture branches off) must be bit-identical to those of the
     build before those branches existed (SHA-256 below); B1's bound
     counts its two MTBVH walks per pixel with B6's and B7's counters on
     the same rays; B3's time and its share of lanes equal to the twin
     bit for bit at each of the 5 levels;
  4. MTBVH on the headline scene: its 426 triangles forced through B6
     (MTBVH closest hit) + B7 (RIS + MTBVH any hit) + B1b, held against
     B1's packs under the parity gates;
  5. small-frame parity: three whole frames through the kernels vs the
     plain twins on the CPU, at 256x64;
  6. headline main path: renderer.init_state / step at 1920x1080 with the
     EAW denoiser, 8 warm-up + 32 timed frames, launch counts checked;
  7. SVGF on the headline scene: B5 (temporal accumulation), the two
     variance kernels (the variance with level 0's prefilter in one
     launch, and the prefilter of levels 1-4; each timed, the first
     beside the pair of kernels it replaced) and B4 (SVGF level, all 5
     levels) against their twins on B1's G-buffer and a random history
     (B4's time and exact lanes per level), then the main path with
     denoiser=SVGF (launches per frame: fused_di 2, spatial 1,
     svgf_temporal 1, svgf_variance 1 + 4, atrous_svgf 5);
  8. env map and textures: env_scene (has_env_map) and
     textured_scene(aux_maps=True) (with_textures) at 1080p: B1 against
     its twin, the scene forced through B6 + B7 + B1b equal to B1 bit for
     bit, and each scene's main path;
  9. hall kernels vs twins: scenes/hall.txt (81,036 triangles) loaded by
     the port's own loader; B6 and B7 against their brute twins on 32
     whole 1024-pixel tiles spread over the 1080p frame, B1b against its
     twin over the whole frame; kernel times, twin times over the whole
     frame, and the walks' box / triangle tests per ray (kernel counters
     over the frame, the lockstep twin on the tiles); B6's and B7's
     registers (ptxas), the per-warp maximum / mean of their box and
     plane tests on the 8x4-pixel warps they launch (32x1 strips beside),
     and B7's light targets per pixel, which must lie in [n_l, n_l + K x
     S] (n_l light rows, S its checkpoint spacing; B7 bound by one target
     per light row, with the two-pass scan's bound beside it);
 10. hall main path: renderer.init_state / step at 1920x1080, 8 warm-up +
     32 timed frames, launch counts per frame checked (gbuffer 1, reuse 1,
     temporal 1, spatial 1, atrous 5);
 11. the hall under a sky: the same scene file with an equirect sky made
     in code (env_scene's gradient at 512x1024; 512 env-tile light rows,
     640 in all): B6 / B7 against their twins on the 32 tiles, their
     bounds, registers, per-warp spread and B7's targets per pixel as in
     phase 9, then its main path;
 12. general kernels vs twins on the headline scene at 1920x1080: B12
     (primary hit) on frame 1's camera rays and, with its mask of live
     lanes, on the bounce rays that sample_bsdf draws at those hits, B11
     closest hit on those bounce rays and its any-hit variant on NEE
     segments (`kernel_ab.general_rays`), B10 (CDF RIS + winner
     visibility, an MTBVH walk) on the general G-buffer, its counting
     build writing the same pack, with its share of same-pick lanes whose
     occlusion equals the twin's; gates: primitive match >=
     99.8 %, pick match >= 99.5 %, matched lanes within rtol 2e-4 on >=
     99.9 %, M equal on >= 99.99 %, and B11 / B12 equal to their twins
     bit for bit on every lane (their and B10's MTBVH walks' box and
     plane tests per ray and per warp from the counting builds give
     their bounds);
     PT-full's share of dead lanes by bounce, and PT_FULL / PT_INDIRECT
     frames with B12's mask equal bit for bit to frames without it;
 13. general main paths through renderer.init_state / step at 1920x1080:
     PT_DIRECT (8 warm-up + 32 timed frames; launches per frame
     primary_hit 2, any hit 1), PT_FULL at trace_depth 5 (2 + 6 frames;
     primary_hit 7, any hit 5), general ReSTIR DI from init_state(cfg,
     cam) without a scene, denoiser NONE, in cdf mode (primary_hit 1,
     ris_cdf 1) and reference mode (primary_hit 1, any hit 1), 2 + 8
     frames each;
 14. quality gate, as bench.py:49-80: many_light_scene(36, 10) at
     384x384, 64 fused RESTIR_DI frames against 256 PT_DIRECT frames;
     energy_ratio_vs_pt must lie within 5 % of 1.
ReSTIR GI (after phase 14):
 15. B8 (GI path trace) against its twin at 1920x1080 on the headline
     scene, depth 5, on B1's own G-buffer, with the JAX GI tests' gates
     (Lo within rtol 2e-3 on > 0.97 of lanes, mean Lo within 3 %, pdf and
     delta > 0.995, valid > 0.985, xs and ns > 0.99, nv > 0.999), then at
     depth 1 with test_gi_trace_depth1_exact's gates on every lane, and
     at both depths equal to the twin bit for bit on every lane; B8's
     counters give its walks' box and plane tests and path vertices per
     pixel, and the mean per-warp maximum of vertices and box tests; B9
     (GI resolve) against its twin over 3 frames on B8's packs (M equal,
     W within rtol 1e-5 and the indirect within 1e-3, each on >= 0.9999);
 16. the fused GI main path, bench.py:239-243's config (RESTIR_GI at
     1920x1080 on the headline scene, trace_depth 5, no denoiser), 8
     warm-up + 32 timed frames (launches per frame: fused_di 2, spatial 1,
     gi_trace 1, gi_resolve 1), its peak memory and profile; then
     cornell_box() the same way;
 17. the general GI step: init_state(cfg, cam) without a scene at 1080p,
     2 + 8 frames (primary_hit 1, ris_cdf 1, gi_trace 1), its peak memory
     and profile; and at 384x384 the fused GI frame's mean indirect within
     5 % of the general step's over the same 8 frames;
 18. the fallback notice: RESTIR_GI on env_scene() with has_env_map warns
     once, naming the GI gate, and renders a general frame.
The MTBVH walk of the general path (after phase 18):
 19. B13 (the JAX package's lockstep MTBVH walk with the Moller-Trumbore
     leaf test: closest, any and primary hit) and B14 (the BVH heatmap)
     against their twins (`ops.intersect`) at 1920x1080 on the hall, on
     every lane: B13's primary build on the hall's camera rays and, with
     the mask of live lanes, on PT-full's first bounce rays from their
     hits, its closest hit on those bounce rays, its any hit on NEE
     segments from the camera hits (`kernel_ab.general_rays`), B14 on the
     pixel-centre camera rays; gates: bit for bit on every lane (else the
     reference's: primitive mismatch <= 0.2 %, matched lanes within rtol
     2e-4, heatmap counts equal on >= 99.9 %, and the print says so);
     each kernel's registers, walk counters per ray and per warp, time
     and bound, and the twin's time over the frame; B13's primary and any
     hit and B14 take the frame's geometry, as the render paths pass it
     (8x4-pixel warps), and are also launched in ray order (the first
     design, kept for batches without geometry), both held to the same
     bits and timed; their box tests' per-warp maximum / mean on 8x4
     tiles beside 32x1 strips and the share of live lanes; for B14 the
     SASS of each walk loop of its builds without counters
     (`cuobjdump -sass`) counted by kind on the loop's common path (less
     the leaf test), and the ALU-pipe time estimate: ALU-pipe instructions
     per box test x box tests / (SMs x 64 lanes x the SM clock that
     nvidia-smi reads while B14 runs);
     B13's closest hit sorts its rays (the ray key, then the one-sweep
     radix sort of csrc/sort.cu) and walks them through the permutation
     on the octant loops: bit for bit against the twin, its box and
     triangle tests per ray equal to the primary hit's counting build
     (exact_closest_walk, ray order), the key and the sort against their
     twins, the pieces' device ms, and the SASS of its walk loops;
     phase 19's wall prints on its own;
 20. B13's closest hit through the ray-query entry point
     (`intersect_closest` on the hall's bounce rays: one ray key, one
     sort of 1 + passes kernels by the sort's own count, one walk);
 21. general main paths through renderer.init_state / step at 1920x1080,
     2 + 8 frames and a profile each: hall PT-direct (intersector auto:
     the walk; launches per frame mt_primary 2, mt_any 1), hall general
     DI + SVGF (intersector "bvh", which the fused gate refuses, cdf
     mode: mt_primary 1, ris_cdf 1, svgf_variance 1 + 4, atrous_svgf 5),
     hall heatmap (BVH_VISUALIZE: heatmap 1, mt_primary 1 for the
     G-buffer), headline PT-direct with the Sobol sampler and EAW
     (primary_hit 2, any_hit 1, atrous_eaw 5);
 22. hall energy: 64 fused RESTIR_DI frames of the hall against 256
     PT_DIRECT frames (the walk, B13) at 384x384, `energy_ratio_vs_pt`
     printed on a line of its own, and the same ratio against 256
     PT_DIRECT frames with intersector "brute" (B11 / B12's plane-test
     walk) beside it; the fused frame in each of the four reuse modes,
     the general ReSTIR DI step in reference mode (reuse NONE, 64
     frames) and PT_FULL at depth 1 (256 frames) as two more estimators,
     each image's light by material (the pixel-centre hit's); a
     measurement, not a gate (`energy.py frames --device cuda` compares
     the same estimators over more frames, off this script).
The app shell (after phase 22):
 23. the CLI in-process (`restir_tpu_torch.app.main`, the user's
     `python -m restir_tpu_torch`): `--builtin many_light --width 1920
     --height 1080 --denoiser eaw --frames 40` (launches per frame:
     fused_di 2, spatial 1, atrous_eaw 5; the PNG not black; the stats
     line with the JAX CLI's keys), `--tracer pt_direct` at 1080p for 8
     frames (primary_hit 2, any_hit 1), and one subprocess `python -m
     restir_tpu_torch --builtin cornell --frames 4 --stats-json`, which
     must load the kernel library this process built, not rebuild it;
 24. the native BVH builder on the hall: numpy and native trees equal bit
     for bit on this host, both builders' times and both scene set-ups
     (parse + build); then `scenes/hall.txt` through the CLI for 10
     frames with `--save-state`, resumed with `--load-state` for 4, and
     14 straight frames, which the resumed run must match (launches per
     frame: gbuffer_bvh 1, reuse_bvh 1, temporal 1, spatial 1);
 25. the browser viewer (`viewer.make_server`) on the headline builtin at
     the CLI's 800x800 on 127.0.0.1: PNG frames arrive on /stream,
     /ctl?tracer=pt_direct and /ctl?key=w each restart /stats' iteration
     and change the stream; its fps, its launches (primary_hit, ris_cdf,
     any_hit), and a clean stop of the server and the render thread.
Row bands (`restir_tpu_torch.parallel`, after phase 25):
 26. (a) B6, B7, B1b, B2 and B5 on the middle band of a 3-band split of
     the headline at 1080p (2025 tiles, 675 per band; frame 2 of a static
     camera, live temporal history; the band's previous packs with their
     halos): each against its twin on the band under its phase's gates,
     each band output equal bit for bit to the same kernel's whole-frame
     output at the band's pixels, each kernel's time on the band; (b)
     `make_fused_sharded_step` on [cuda:0] x 3 from `init_state`, 3
     frames with EAW, then with SVGF: the gathered frames equal those of
     a one-band mesh bit for bit, and renderer.step's (B1) within the JAX
     test's rtol 1e-5 / atol 1e-6, with the share of equal lanes
     printed; (c) 8 warm-up + 32 timed frames of the 3-band EAW path
     (launches per frame: gbuffer_bvh 3, reuse_bvh 3, temporal 3,
     spatial 3, atrous_eaw 15: each band runs the 5 levels on its own
     row-haloed image), its wall and fps beside phase 6's, and its
     profile.
 27. the general frame in row bands (`make_sharded_step`, after 26).
The stage probes (`restir_tpu_torch.prof`, after phase 27):
 28. (a) each kernel of csrc/prof/ against its plain twin at its probe's
     shapes: the coherence key, the one-sweep radix sort (against
     torch.sort(stable=True); 1 + passes launches a sort), the permuted
     [9, R] gather, the gather of B13's inputs, the scatter of its flags
     and the copy floor on the hall's 1080p NEE segments in all three key
     orders, bit for bit, and the sort once on 3840x2160 keys (above the
     parent design's 4,194,304-key cap); the any hit's
     three forms (FP32 FMA, 3xTF32 and 6xTF32 wgmma tiles with the
     plane pieces split once a block; their ptxas registers, the SASS
     of the tensor-core step loop and of the FP32 form's row loops, whose
     instructions a pair and issue time print) on 1080p random rays against the
     headline's 512 padded plane rows within the primitive gate
     (mismatch <= 0.2 %); the table gathers (shared memory on a grid
     the card holds at once, __ldg, texture; R = 1920 x 1088, K = 1024
     and 8192, the kernels line K = 8192's; timed with index and output
     cold in L2) and the vec3 chains (SoA, AoS, float4) bit for bit,
     with each chain's SASS a pixel and a round and its issue time (its
     bound counts each of the 540 rounded operations a pixel as a whole
     FP32 lane slot);
     each kernel's device time (its kernels' summed durations in a
     torch.profiler trace, the CUDA events around back-to-back calls
     printed beside), its twin's, one PyTorch call's where one computes
     the same function (torch.sort, index_select, index_copy_, copy_,
     torch.matmul of the any hit's dots) and its bound; the sort's
     launches one by one; the stage builds' own bounds (B7 and B10
     search-only, fixed-node, no-leaf, no-exit) from their counted
     tests; (b) the B6, B7 and B10 builds of the stage
     probes without a PROBE macro (`_build.VARIANTS`' "*_full") write
     the main library's packs bit for bit on the hall, the sky hall and
     the headline; (c) the slice's main path, `python -m
     restir_tpu_torch.prof all` (every probe once, 1 warm-up and 5 timed
     launches a row), with its launch counts: every kernel of
     csrc/prof/ must launch. Phase 2 builds the probes' libraries with
     the main one.
Many lights (after phase 28):
 29. light tables past what a block could stage whole: B7 and B10,
     whose light search (`ris_search` in the kernels line, a kernel of
     its own that both launch before their shadow walks) streams the
     light rows through shared memory at every size: (a)
     many_light_scene(1225, 24) (2,450 light rows, 2,748 triangles): B7
     + B1b against their twins on 32 sample tiles, the search alone
     against its twin (`fused_di.ris_all`) and its CPU mirror's light
     targets (`reuse.ris_search`) on the same tiles, and B10 against its
     twin on a band of 16 rows, with phase 9's and phase 12's gates,
     and each kernel's time (the search and each walk apart), twin's
     time and bound; the fused RESTIR_DI + EAW frame through
     renderer.step at 1920x1080 (launches per frame: gbuffer_bvh 1,
     reuse_bvh 1, ris_search 1, temporal 1, spatial 1, atrous_eaw 5) and
     the general RESTIR_DI cdf + EAW frame (primary_hit 1, ris_cdf 1,
     ris_search 1, atrous_eaw 5), each with its wall, device busy and
     idle share (profile), and phase 14's quality gate on this scene at
     384x384: energy_ratio_vs_pt within 5 % of 1; (b)
     many_light_scene(5000, 24) (10,000 light rows; its quads overlap):
     the same kernel-against-twin checks and times, and 2 + 4 frames of
     each main path.
Phases 12-14 run after phase 11, phases 15-18 after them, 19-22 after
those, 23-25, then 26, 27, 28 and 29, last. Each phase's wall seconds
print on a line of their own ("phase wall: <phase>: <s> s") as it ends.
After each main path, torch.profiler traces 4 more frames and prints the
device busy time per frame and the kernels that take it.
The last three stdout lines are the card's name and power limit (from
nvidia-smi), the per-kernel JSON record and {"ok": true, "device": ...}.
Bounds use the H100 SXM's published peaks: 3.35 TB/s, 67 TFLOP/s
float32 (non-tensor) and 495 TFLOP/s TF32 (tensor cores, dense);
operation counts per test are counted from the CUDA sources (constants
below; a transcendental counts as one).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from restir_tpu_torch import app, convert, parallel, parity, renderer, viewer
from restir_tpu_torch.models import denoiser
from restir_tpu_torch.config import (
    DenoiserType,
    RenderConfig,
    ReuseMode,
    TracerType,
    mat_flags,
)
from restir_tpu_torch.models import gbuffer as general_gb
from restir_tpu_torch.models import restir_di, restir_di_fused, restir_gi
from restir_tpu_torch.ops import reservoir as rsv
from restir_tpu_torch.ops import intersect, intersect_bf
from restir_tpu_torch.ops.camera import (
    make_camera,
    pack_camera,
    pixel_centers,
    sample_rays,
    update_camera,
)
from restir_tpu_torch.ops.kernels import (
    _build,
    atrous,
    bvh_walk,
    fused_di,
    gbuffer,
    gi,
    reuse,
    ris_cdf,
    spatial,
    svgf,
)
from restir_tpu_torch.ops.kernels import intersect as hits
from restir_tpu_torch.ops.kernels import ray_order
from restir_tpu_torch.ops.kernels.fused_di import (
    G_DIR,
    G_POS,
    G_PRIM,
    P_M,
    PT_CH,
    RS_DIST,
    RS_LI,
    RS_W,
    RS_WI,
    TILE,
)
from restir_tpu_torch.parallel import fused_sharding, sharding
from restir_tpu_torch.scene import bvh as scene_bvh
from restir_tpu_torch.scene.loader import parse_scene_file
from restir_tpu_torch.scene.procedural import (
    cornell_box,
    env_scene,
    gradient_sky,
    many_light_scene,
    textured_scene,
)

from restir_tpu_torch.utils.image_io import encode_png, read_pfm, read_png

from kernel_ab import b10_input, general_rays

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
WARMUP, TIMED = 8, 32
SAMPLE_TILES = 32
SOURCES = {
    "fused_di": ("restir_tpu_torch/csrc/fused_di.cu",
                 "restir_tpu/ops/pallas/fused_di.py:2778"),
    "spatial": ("restir_tpu_torch/csrc/spatial.cu",
                "restir_tpu/ops/pallas/fused_di.py:3106"),
    "atrous_eaw": ("restir_tpu_torch/csrc/atrous.cu",
                   "restir_tpu/ops/pallas/atrous_kernel.py:90"),
    "gbuffer_bvh": ("restir_tpu_torch/csrc/gbuffer_bvh.cu",
                    "restir_tpu/ops/pallas/fused_di.py:907"),
    "reuse_bvh": ("restir_tpu_torch/csrc/reuse_bvh.cu",
                  "restir_tpu/ops/pallas/fused_di.py:1558"),
    "fused_di_env": ("restir_tpu_torch/csrc/fused_di.cu",
                     "restir_tpu/ops/pallas/fused_di.py:2778"),
    "fused_di_textures": ("restir_tpu_torch/csrc/fused_di.cu",
                          "restir_tpu/ops/pallas/fused_di.py:2778"),
    "svgf_temporal": ("restir_tpu_torch/csrc/svgf.cu",
                      "restir_tpu/ops/pallas/fused_di.py:2986"),
    "svgf_variance": ("restir_tpu_torch/csrc/svgf.cu",
                      "restir_tpu/models/denoiser.py:221"),
    "atrous_svgf": ("restir_tpu_torch/csrc/atrous.cu",
                    "restir_tpu/ops/pallas/atrous_kernel.py:90"),
    "primary_hit": ("restir_tpu_torch/csrc/intersect.cu",
                    "restir_tpu/ops/pallas/intersect_kernel.py:200"),
    "closest_hit": ("restir_tpu_torch/csrc/intersect.cu",
                    "restir_tpu/ops/pallas/intersect_kernel.py:162"),
    "any_hit": ("restir_tpu_torch/csrc/intersect.cu",
                "restir_tpu/ops/pallas/intersect_kernel.py:376"),
    "ris_cdf": ("restir_tpu_torch/csrc/ris_cdf.cu",
                "restir_tpu/ops/pallas/ris_kernel.py:138"),
    "gi_trace": ("restir_tpu_torch/csrc/gi_trace.cu",
                 "restir_tpu/ops/pallas/gi_kernel.py:325"),
    "gi_resolve": ("restir_tpu_torch/csrc/gi_resolve.cu",
                   "restir_tpu/ops/pallas/gi_kernel.py:1106"),
    # B13 / B14: counterparts of the JAX package's XLA walks, not of
    # Pallas kernels
    "mt_closest": ("restir_tpu_torch/csrc/intersect.cu",
                   "restir_tpu/ops/intersect.py:145"),
    "mt_any": ("restir_tpu_torch/csrc/intersect.cu",
               "restir_tpu/ops/intersect.py:201"),
    "mt_primary": ("restir_tpu_torch/csrc/intersect.cu",
                   "restir_tpu/ops/intersect.py:145"),
    "heatmap": ("restir_tpu_torch/csrc/intersect.cu",
                "restir_tpu/ops/intersect.py:252"),
    # B13's closest hit sorts its rays: the ray key and the radix sort
    # (csrc/sort.cu, the probes' sort) on the ray query's path
    "ray_key": ("restir_tpu_torch/csrc/sort.cu",
                "restir_tpu/ops/intersect.py:145"),
    "ray_sort": ("restir_tpu_torch/csrc/sort.cu",
                 "restir_tpu/ops/intersect.py:145"),
    # the stage probes' kernels (restir_tpu_torch.prof, phase 28)
    "prof_key": ("restir_tpu_torch/csrc/sort.cu",
                 "prof/prof_wavefront.py:87"),
    "prof_radix_sort": ("restir_tpu_torch/csrc/sort.cu",
                        "prof/prof_wavefront.py:87"),
    "prof_gather": ("restir_tpu_torch/csrc/sort.cu",
                    "prof/prof_take.py:140"),
    "prof_scatter": ("restir_tpu_torch/csrc/sort.cu",
                     "prof/prof_wavefront.py:87"),
    "prof_copy": ("restir_tpu_torch/csrc/sort.cu",
                  "prof/prof_take.py:140"),
    "prof_anyhit_fma": ("restir_tpu_torch/csrc/prof/anyhit.cu",
                        "prof/prof_fma.py:139"),
    "prof_anyhit_mma3": ("restir_tpu_torch/csrc/prof/anyhit.cu",
                         "prof/prof_fma.py:116"),
    "prof_anyhit_mma6": ("restir_tpu_torch/csrc/prof/anyhit.cu",
                         "prof/prof_fma.py:116"),
    "prof_table_gather_shared": ("restir_tpu_torch/csrc/prof/mem.cu",
                                 "prof/prof_gather.py:43"),
    "prof_table_gather_ldg": ("restir_tpu_torch/csrc/prof/mem.cu",
                              "prof/prof_gather.py:43"),
    "prof_table_gather_tex": ("restir_tpu_torch/csrc/prof/mem.cu",
                              "prof/prof_gather.py:43"),
    "prof_chain_soa": ("restir_tpu_torch/csrc/prof/mem.cu",
                       "prof/prof_v3.py:92"),
    "prof_chain_aos": ("restir_tpu_torch/csrc/prof/mem.cu",
                       "prof/prof_v3.py:92"),
    "prof_chain_float4": ("restir_tpu_torch/csrc/prof/mem.cu",
                          "prof/prof_v3.py:92"),
    # B7's light search, a launch of its own before the walks of B7 and
    # of B10 (phases 9 and 29)
    "ris_search": ("restir_tpu_torch/csrc/ris_search.cuh",
                   "restir_tpu/ops/pallas/fused_di.py:1558"),
}
GENERAL_WARMUP, GENERAL_TIMED = 2, 8  # PT_FULL and general DI frames
# SHA-256 of B1's gb and pt packs in phase 3 (frame 1 of the headline at
# 1920x1080), as the build of commit 4a151c4 wrote them on an H100: the
# env-less, texture-less B1 must stay bit-identical to it.
B1_DIGEST = "11194a5e87d400d93a9e80b1599928de6f5961e9ad32555f399ef46bf78219af"

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
# floating-point operations per unit of work, counted from csrc/ (an FMA
# counts 2, a division or square root 1, min / max 1)
FLOP_PLANE = 39  # plane_hit: 3 four-term + 3 three-term dots, div, u, v
FLOP_BOX = 24  # slab: 6 sub, 6 mul, 12 min / max
FLOP_LIGHT = 32  # light_target
# env_target: n.d (2 FMA + 1 mul), a + rad, 0.1 rad, max, lum x, cdf add
FLOP_ENV_LIGHT = 10
FLOP_CAND = 120  # one RIS candidate: sample point, pdf, BSDF, weight
FLOP_PIXEL = 150  # raygen + G-buffer epilogue
FLOP_TEMPORAL = 40  # B1b's merge
FLOP_B4_TAP = 50  # one SVGF tap: 3 weights (3 exp, 1 log), 4 sums
FLOP_B5 = 40  # B5's test and blend
FLOP_VAR = 40  # variance estimate + level 0's prefilter, per pixel
FLOP_PREFILTER = 20  # one 3x3 prefilter of the variance, per pixel
FLOP_B12_EPI = 60  # B12's interpolation of pos / normal / uv
# one B8 path vertex without its plane tests: a Lambert vertex's NEE
# (light point, normal, pdf, shadow-ray set-up, BSDF eval and MIS ~200),
# BSDF sample (~70), hit interpolation and light MIS (~70), throughput;
# metallic vertices cost more, so the bound this gives is low
FLOP_GI_VERTEX = 350
FLOP_GI_RESOLVE = 120  # B9 per pixel: RIS, merge tests, cap, shade
# MtRay: edges and offset (9 sub), two cross products (18), four dots
# (20), three divisions, six compares
FLOP_MT = 56
FLOP_SEGMENT = 16  # B13's any-hit set-up: |y - x|, d, origin, limit
PEAK_TF32 = 495e12  # H100 SXM TF32 tensor cores, dense, FLOP/s
# the probes' kernels (csrc/prof/): the coherence key of one segment
# (two Morton codes or a direction: about 60 operations), one (ray, row)
# pair of the any hit's epilogue (division, u, v, 6 compares) and its six
# dots (3 four-term and 3 three-term: 21 multiply-adds). The tensor-core
# forms do the same 21 multiply-adds once per split product (3 in
# 3xTF32, 6 in 6xTF32); the zero K slot of the d-dots' tiles is not work
# the function needs, so it is not counted.
FLOP_KEY = 60
# B13's ray key (csrc/sort.cu ray_key_kernel) on a live ray: 6 NaN tests,
# the table of -d (3 abs, 5 compares), safe_inv of d (abs, 2 compares and
# a division an axis) and its 3 zero tests, 3 infinity tests of o, 2 sign
# tests, 3 abs of d, the root box's 3 extents, and 5 cells (3 of the
# Morton code, 2 of the direction: subtract, divide, compare, min,
# multiply, convert each)
FLOP_RAY_KEY = 6 + 8 + 3 * 4 + 3 + 3 + 2 + 3 + 3 + 5 * 6  # 70
FLOP_ANY_EPI = 12
FLOP_ANY_DOTS = 42


class PhaseError(RuntimeError):
    pass


MAIN_WALL = {}  # wall ms per frame of each main path run so far
_PHASE_END = [time.perf_counter()]  # when the last phase ended


def phase_wall(what: str) -> None:
    """Print, on a line of its own, the wall seconds since the last phase
    ended (since the script started, for the first)."""
    now = time.perf_counter()
    print(f"phase wall: {what}: {now - _PHASE_END[0]:.1f} s", flush=True)
    _PHASE_END[0] = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of fn() over `reps` calls."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, match: str, tries: int = 3) -> float:
    """Mean device time per call of the kernels whose name holds `match`,
    from a torch.profiler trace of `reps` calls of fn after one profiled
    but discarded call (a trace may miss the first kernels after it
    starts; one with a count other than `reps` is taken again, up to
    `tries` times, else nan). For kernels shorter than their wrapper's
    host time, which CUDA events around back-to-back calls measure
    instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and match in e.name]
        if len(us) == reps:
            return sum(us) / reps / 1e3
    return float("nan")


def bound(nbytes: float, flops: float):
    """(least ms on the card, what binds it)."""
    ms_b = nbytes / PEAK_BYTES * 1e3
    ms_f = flops / PEAK_FLOPS * 1e3
    return (ms_b, "bytes") if ms_b >= ms_f else (ms_f, "operations")


def table_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def render_config(scene_arrays, width=None, height=None, **kw):
    kw.setdefault("denoiser", DenoiserType.EAW)
    return RenderConfig(width=width or WIDTH, height=height or HEIGHT,
                        tracer=TracerType.RESTIR_DI,
                        **mat_flags(scene_arrays), **kw)


def reset_counts():
    fused_di.launches = 0
    fused_di.temporal_launches = 0
    spatial.launches = 0
    atrous.launches = 0
    atrous.svgf_launches = 0
    gbuffer.launches = 0
    reuse.launches = 0
    svgf.temporal_launches = 0
    svgf.variance_launches = 0
    hits.primary_launches = 0
    hits.closest_launches = 0
    hits.any_launches = 0
    ris_cdf.launches = 0
    reuse.search_launches = 0
    gi.trace_launches = 0
    gi.resolve_launches = 0
    hits.mt_closest_launches = 0
    hits.mt_any_launches = 0
    hits.mt_primary_launches = 0
    hits.heatmap_launches = 0
    ray_order.key_launches = 0
    ray_order.sort_launches = 0


def read_counts():
    return {"fused_di": fused_di.launches,
            "temporal": fused_di.temporal_launches,
            "spatial": spatial.launches, "atrous_eaw": atrous.launches,
            "atrous_svgf": atrous.svgf_launches,
            "gbuffer_bvh": gbuffer.launches, "reuse_bvh": reuse.launches,
            "svgf_temporal": svgf.temporal_launches,
            "svgf_variance": svgf.variance_launches,
            "primary_hit": hits.primary_launches,
            "closest_hit": hits.closest_launches,
            "any_hit": hits.any_launches, "ris_cdf": ris_cdf.launches,
            "gi_trace": gi.trace_launches, "gi_resolve": gi.resolve_launches,
            "mt_closest": hits.mt_closest_launches,
            "mt_any": hits.mt_any_launches,
            "mt_primary": hits.mt_primary_launches,
            "heatmap": hits.heatmap_launches,
            "ray_key": ray_order.key_launches,
            "ray_sort": ray_order.sort_launches,
            "ris_search": reuse.search_launches}


def packs_digest(*packs) -> str:
    h = hashlib.sha256()
    for t in packs:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gate(fails, what):
    if fails:
        raise PhaseError(f"{what}: " + "; ".join(fails))


def phase_build():
    t0 = time.perf_counter()
    # the main library and every stage probe's build, one nvcc per
    # source, all started together
    path = _build.build(variants=tuple(_build.VARIANTS))
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s) -> {os.path.basename(path)}")
    if _build.build_log is None:
        print("ptxas: the library was cached, no register report")
        return
    # registers and spills: ptxas's report of every kernel
    src = name = None
    for ln in _build.build_log.splitlines():
        if ln.startswith("--- "):
            src = ln[4:]
        elif "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "registers" in ln and name:
            print(f"ptxas {src} {name[:72]}:{ln.split(':', 1)[1]}")
        elif "spill" in ln and name:
            print(f"ptxas {src}   {ln.strip()}")


def phase_kernels(scene, cfg, cam, dev, record):
    """B1, B2 and B3 against their plain twins on the card at 1080p."""
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    cam2 = make_camera(position=(0.25, 4.5, 15.0),
                       rotation=(-90.5, -10.0, 0.0), fov_y=30.0)
    cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
    kw = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
              single_sided=cfg.single_sided_lights, k=cfg.cdf_candidates,
              temporal=True, temporal_clamp=cfg.temporal_clamp,
              has_met=cfg.scene_has_metallic)
    t, bvh = scene.tables, scene.bvh
    zeros = torch.zeros((PT_CH, r), device=dev)
    # frame 0 (no history), then frame 1 from a moved camera with the
    # kernel's frame-0 pack as history: temporal merges and motion live
    _, pt0 = fused_di.di_resident_cuda(cv, cv, 0, zeros, t, bvh, **kw)
    gb_k, pt_k = fused_di.di_resident_cuda(cv2, cv, 1, pt0, t, bvh, **kw)
    gb_r, pt_r = fused_di.di_resident_ref(cv2, cv, 1, pt0, t, **kw)
    torch.cuda.synchronize()
    digest = packs_digest(gb_k, pt_k)
    print(f"B1 packs SHA-256 {digest} (build before the env / texture "
          f"branches: {B1_DIGEST}): "
          f"{'bit-identical' if digest == B1_DIGEST else 'DIFFERENT'}")
    if digest != B1_DIGEST:
        raise PhaseError("the env-less B1 is not bit-identical to its build "
                         "before the env / texture branches")
    fails, stats = parity.gb_pt_report(gb_r, pt_r, gb_k, pt_k)
    print(f"B1 fused_di vs twin: {json.dumps(stats)}")
    gate(fails, "B1 disagrees with its twin")
    m_live = float(pt_k[P_M].max())
    if m_live <= cfg.cdf_candidates:
        raise PhaseError(f"B1 temporal merge inactive (max M {m_live})")
    err_b1 = max(stats["pos_max_abs_err"], stats["weight_max_abs_err"])
    ms_b1 = cuda_ms(lambda: fused_di.di_resident_cuda(cv2, cv, 1, pt0, t,
                                                      bvh, **kw), 10)
    ms_b1_ref = cuda_ms(lambda: fused_di.di_resident_ref(cv2, cv, 1, pt0, t,
                                                         **kw), 2)
    b1 = b1_bound(scene, gb_k, cv2, cv, cfg, False)
    record["fused_di"] = dict(max_abs_err=err_b1, ms=ms_b1,
                              plain_ms=ms_b1_ref, bound_ms=b1[0],
                              bound_by=b1[1], library_ms=None)
    print(f"B1 fused_di: kernel {ms_b1:.4f} ms, twin {ms_b1_ref:.4f} ms, "
          f"bound {b1[0]:.4f} ms ({b1[1]}; {b1[2]})")

    # B2 on the same packs, a random accumulator, iteration 3
    offs = spatial.spatial_offsets(1, r, w, cfg.spatial_neighbors,
                                   cfg.spatial_radius, dev)
    acc0 = torch.as_tensor(
        np.random.default_rng(0).random((3, r), dtype=np.float32), device=dev)
    skw = dict(width=w, height=h, neighbors=cfg.spatial_neighbors,
               has_met=cfg.scene_has_metallic)
    acc_k = spatial.spatial_shade_cuda(offs, gb_k, pt_k, acc0.clone(), 1, 3,
                                       **skw)
    acc_r = spatial.spatial_shade_ref(offs, gb_k, pt_k, acc0.clone(), 1, 3,
                                      **skw)
    frac = parity.close_fraction(acc_r, acc_k, 1e-5, 1e-6)
    err_b2 = float((acc_r - acc_k).abs().max())
    print(f"B2 spatial vs twin: close {frac:.6f}, max abs err {err_b2:.3g}")
    if frac < 0.999:
        raise PhaseError(f"B2 disagrees with its twin on {1 - frac:.5f}")
    scratch = acc0.clone()
    ms_b2 = cuda_ms(lambda: spatial.spatial_shade_cuda(
        offs, gb_k, pt_k, scratch, 1, 3, **skw), 20)
    ms_b2_ref = cuda_ms(lambda: spatial.spatial_shade_ref(
        offs, gb_k, pt_k, scratch, 1, 3, **skw), 2)
    # 20 gb + 13 pt channels read, accum read and written
    b2 = bound(r * (20 + 13 + 3 + 3) * 4,
               r * cfg.spatial_neighbors * 60 + r * 80)
    record["spatial"] = dict(max_abs_err=err_b2, ms=ms_b2,
                             plain_ms=ms_b2_ref, bound_ms=b2[0],
                             bound_by=b2[1], library_ms=None)
    print(f"B2 spatial: kernel {ms_b2:.4f} ms, twin {ms_b2_ref:.4f} ms, "
          f"bound {b2[0]:.4f} ms ({b2[1]})")

    # B3: every level on the demodulated frame
    alb = torch.clamp(gb_k[fused_di.G_ALB:fused_di.G_ALB + 3], min=0.0)
    color = acc_k / torch.where(alb > 1e-4, alb, 1.0)
    akw = dict(width=w, height=h, sig_l=cfg.sig_luminance,
               sig_n=cfg.sig_normal, sig_d=cfg.sig_depth)
    err_b3, ms_b3, ms_b3_ref = 0.0, [], []
    for level in range(cfg.eaw_levels):
        out_k = atrous.atrous_level_cuda(color, gb_k, level=level, **akw)
        out_r = atrous.atrous_level_ref(color, gb_k, level=level, **akw)
        frac = parity.close_fraction(out_r, out_k, 1e-5, 1e-6)
        err = float((out_r - out_k).abs().max())
        err_b3 = max(err_b3, err)
        exact = float(bits_equal(out_k, out_r).all(0).float().mean())
        print(f"B3 level {level} vs twin: close {frac:.6f}, exact lanes "
              f"{exact:.6f}, max abs err {err:.3g}")
        if frac < 0.999:
            raise PhaseError(f"B3 level {level} disagrees on {1 - frac:.5f}")
        ms_b3.append(cuda_ms(lambda: atrous.atrous_level_cuda(
            color, gb_k, level=level, **akw), 20))
        ms_b3_ref.append(cuda_ms(lambda: atrous.atrous_level_ref(
            color, gb_k, level=level, **akw), 2))
        color = out_k
    # color 3 + gb prim / normal / position 7 read, 3 written; 25 taps
    b3 = bound(r * (3 + 7 + 3) * 4, r * 25 * 30)
    record["atrous_eaw"] = dict(max_abs_err=err_b3,
                                ms=float(np.mean(ms_b3)),
                                plain_ms=float(np.mean(ms_b3_ref)),
                                bound_ms=b3[0], bound_by=b3[1],
                                library_ms=None)
    print("B3 atrous per level: kernel "
          + ", ".join(f"{x:.4f}" for x in ms_b3) + " ms; twin "
          + ", ".join(f"{x:.4f}" for x in ms_b3_ref) + f" ms; bound "
          f"{b3[0]:.4f} ms ({b3[1]})")
    return cv, cv2, pt0, gb_k, pt_k


def phase_mtbvh_headline(scene, cfg, dev, cv, cv2, pt0, gb_b1, pt_b1):
    """The resident scene through B6 + B7 + B1b, held against B1."""
    w, h = cfg.width, cfg.height
    gb = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, width=w, height=h,
                              aa_jitter=cfg.aa_jitter,
                              single_sided=cfg.single_sided_lights)
    pt = reuse.reuse_cuda(gb, pt0, 1, scene.tables, scene.bvh,
                          k=cfg.cdf_candidates,
                          single_sided=cfg.single_sided_lights,
                          temporal_clamp=cfg.temporal_clamp,
                          has_met=cfg.scene_has_metallic, width=w)
    torch.cuda.synchronize()
    fails, stats = parity.gb_pt_report(gb_b1, pt_b1, gb, pt)
    print(f"MTBVH (B6 + B7 + B1b) vs B1 on the {scene.num_tris}-triangle "
          f"headline scene at {w}x{h}: {json.dumps(stats)}")
    gate(fails, "B6 + B7 + B1b disagree with B1")
    ms6 = cuda_ms(lambda: gbuffer.gbuffer_cuda(
        cv2, cv, 1, scene.bvh, width=w, height=h), 10)
    ms7 = cuda_ms(lambda: reuse.candidates_cuda(
        gb, 1, scene.tables, scene.bvh, k=cfg.cdf_candidates,
        has_met=cfg.scene_has_metallic, width=w), 10)
    # bounds from this frame's walk counts (kernel counters)
    _, cnt6 = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, width=w, height=h,
                                   stats=True)
    _, cnt7 = reuse.candidates_cuda(gb, 1, scene.tables, scene.bvh,
                                    k=cfg.cdf_candidates,
                                    has_met=cfg.scene_has_metallic,
                                    width=w, stats=True)
    b6 = walk_bound6(scene.bvh, w * h, cnt6)
    b7 = walk_bound7(scene.tables, scene.bvh, w * h, cfg.cdf_candidates,
                     cnt7, False)
    ms6_ref = cuda_ms(lambda: gbuffer.gbuffer_ref(
        cv2, cv, 1, scene.bvh, width=w, height=h), 1, warmup=False)
    ms7_ref = cuda_ms(lambda: reuse.reuse_ref(
        gb, pt0, 1, scene.tables, k=cfg.cdf_candidates,
        has_met=cfg.scene_has_metallic), 1, warmup=False)
    print(f"headline scene: B6 {ms6:.4f} ms (bound {b6[0]:.4f} ms, "
          f"{b6[1]}; twin {ms6_ref:.2f} ms), B7 {ms7:.4f} ms (bound "
          f"{b7[0]:.4f} ms, {b7[1]}; twin with B1b {ms7_ref:.2f} ms) (B1 "
          f"resident path for comparison above)")


def walk_bound6(bvh, r, counts):
    """(least ms, what binds it) of B6 over this frame's box / triangle
    tests (kernel counters [2, R])."""
    boxes, tris = (float(c.double().sum()) for c in counts)
    return bound(table_bytes(bvh.planes, bvh.attr, bvh.mat, bvh.rows)
                 + r * 24 * 4,
                 r * FLOP_PIXEL + boxes * FLOP_BOX + tris * FLOP_PLANE)


def light_count(t, has_env):
    """The light rows that hold lights (area lights, then env tiles); the
    tables' zero padding rows are no work of the function."""
    return t.n_lights + (t.env_rad.shape[0] if has_env else 0)


def walk_bound7(t, bvh, r, k, counts, has_env, passes=1):
    """(least ms, what binds it) of B7 over this frame's shadow-walk
    tests (kernel counters [3, R]): one light target per light row (area
    rows at FLOP_LIGHT, env-tile rows at FLOP_ENV_LIGHT), k candidates and
    the walk. passes=2 counts every light row twice at FLOP_LIGHT: the
    bound of the full two-pass scan (B7's first design)."""
    boxes, tris = (float(c.double().sum()) for c in counts[:2])
    lights, psi = t.light_rows(has_env)
    n_l = light_count(t, has_env)
    n_env = n_l - t.n_lights
    targets = (2 * n_l * FLOP_LIGHT if passes == 2 else
               t.n_lights * FLOP_LIGHT + n_env * FLOP_ENV_LIGHT)
    return bound(table_bytes(lights[:n_l], psi[:n_l], bvh.planes, bvh.rows)
                 + r * (24 + 8) * 4,
                 r * (targets + k * FLOP_CAND)
                 + boxes * FLOP_BOX + tris * FLOP_PLANE)


def ris_bound10(t, r, k, boxes, tests, walk_tables):
    """(least ms, what binds it) of B10 over this run's shadow-walk
    tests: the packs, the light rows that hold lights and the walk's
    tables moved once; one light target per light row (the picks need no
    second scan: B7's search, which B10 runs, picks the
    full scan's rows), k candidates and the walk."""
    n_l = t.n_lights
    return bound(r * (ris_cdf.CIN + ris_cdf.COUT) * 4
                 + table_bytes(t.lights[:n_l], t.psi[:n_l]) + walk_tables,
                 r * (n_l * FLOP_LIGHT + k * FLOP_CAND)
                 + boxes * FLOP_BOX + tests * FLOP_PLANE)


def warp_spread(counts, width, height):
    """(mean, per-warp maximum / mean) of per-pixel counts over the 8x4
    pixel tiles B6 and B7 launch as warps, and the same ratio for 32x1
    strips (warps in linear pixel order)."""
    img = counts.view(height, width).double()
    mean = float(img.mean())
    tiles = img.view(height // 4, 4, width // 8, 8).amax(dim=(1, 3))
    strips = img.view(height, width // 32, 32).amax(dim=2)
    return (mean, float(tiles.mean()) / max(mean, 1e-30),
            float(strips.mean()) / max(mean, 1e-30))


def ptxas_report(source, kernel):
    """'registers / spill stores' of each build of `kernel` in `source`,
    from this run's nvcc log (phase 2), keyed by its template arguments
    (bool and int)."""
    out, src, name, spill = {}, None, None, None
    mangled = f"{len(kernel)}{kernel}"  # the name as the symbol spells it
    for ln in (_build.build_log or "").splitlines():
        if ln.startswith("--- "):
            src = ln[4:]
        elif "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif src == source and name and mangled in name:
            if "spill stores" in ln:
                spill = ln.split("bytes spill stores")[0].split(",")[-1]
            elif "registers" in ln:
                flags = name.split(mangled, 1)[1].split("EE", 1)[0]
                key = "<" + ",".join(
                    f.lstrip("I")[2:] for f in flags.split("E")
                    if f.lstrip("I")[:2] in ("Lb", "Li")) + ">"
                regs = ln.split("Used")[1].split("registers")[0].strip()
                out[key] = f"{regs} registers, {spill.strip()} B spilled"
    return out or "not reported (cached build)"


# SASS opcodes by kind, for the instruction counts of a walk's loop; the
# ALU pipe (16 lanes per clock per SM sub-partition) issues the min / max,
# compares, selects and integer logic, the FMA pipe FADD / FMUL / FFMA
# and IMAD
SASS_KINDS = (
    ("FADD/FMUL/FFMA", ("FADD", "FMUL", "FFMA")),
    ("FMNMX", ("FMNMX",)),
    ("compare/select", ("FSETP", "ISETP", "FSEL", "SEL", "PLOP3", "P2R",
                        "R2P")),
    ("loads", ("LDG", "LD", "LDS", "LDC", "ULDC")),
    ("address/integer", ("IMAD", "IADD3", "LEA", "SHF", "LOP3", "MOV",
                         "IMNMX", "VIMNMX", "PRMT", "UMOV", "ULEA",
                         "UIADD3", "UIMAD")),
    ("branch/sync", ("BRA", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "NOP")),
)
ALU_PIPE = {"FMNMX", "FSETP", "ISETP", "FSEL", "SEL", "PLOP3", "P2R", "R2P",
            "IADD3", "LEA", "SHF", "LOP3", "MOV", "IMNMX", "VIMNMX", "PRMT"}


@functools.lru_cache(maxsize=None)
def _sass_text(lib: str) -> str:
    """`cuobjdump -sass` of a built library, once per library."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise PhaseError(f"cuobjdump failed: {out.stderr[-2000:]}")
    return out.stdout


def _sass_functions(lib, kernel):
    """{symbol: [(address, opcode, predicated, branch target or None)]}
    of every function in `lib` whose symbol holds `kernel`, from
    `cuobjdump -sass`."""
    import re

    mangled = f"{len(kernel)}{kernel}"
    funcs, cur, labels, pending = {}, None, {}, []
    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
    for ln in _sass_text(str(lib)).splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            cur = funcs.setdefault(name, []) if mangled in name else None
            labels, pending = {}, []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = ins.search(ln)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[lab] = addr
        pending = []
        pred = text.startswith("@")
        op = (text.split()[1] if pred else text.split()[0]).split(".")[0]
        tgt = None
        if op == "BRA":
            t = re.search(r"0x([0-9a-f]+)|\((\.L_x_\d+)\)", text)
            if t:
                tgt = int(t.group(1), 16) if t.group(1) else t.group(2)
        cur.append([addr, op, pred, tgt])
        cur[-1].append(labels)
    for name, code in funcs.items():
        for row in code:
            labs = row.pop()
            if isinstance(row[3], str):
                row[3] = labs.get(row[3])
    return funcs


def sass_loops(lib, kernel):
    """Per function of `kernel` and per loop (a backward branch): the
    instructions of the loop by kind, whole and on its common path (less
    the ranges that a predicated forward branch inside the loop skips,
    such as a leaf's triangle test), and of those the ALU pipe's; and
    the whole loop's instructions by opcode ("ops")."""
    res = {}
    for name, code in _sass_functions(lib, kernel).items():
        loops = []
        for addr, op, _, tgt in code:
            if op != "BRA" or tgt is None or tgt > addr:
                continue
            body = [c for c in code if tgt <= c[0] <= addr]
            skip = set()
            for a, o, p, t in body:
                if o == "BRA" and p and t is not None and a < t <= addr:
                    skip.update(c[0] for c in body if a < c[0] < t)
            common = [c for c in body if c[0] not in skip]

            def kinds(rows):
                n = {k: sum(1 for r in rows if r[1] in ops)
                     for k, ops in SASS_KINDS}
                n["other"] = len(rows) - sum(n.values())
                n["ALU pipe"] = sum(1 for r in rows if r[1] in ALU_PIPE)
                n["all"] = len(rows)
                return n

            if len(body) >= 16:  # not a branch-to-self or a short spin
                loops.append({"start": hex(tgt), "end": hex(addr),
                              "whole": kinds(body), "common": kinds(common),
                              "ops": collections.Counter(r[1] for r in body)})
        res[name] = loops
    return res


def sm_clock_mhz(fn, seconds=2.0):
    """Median of nvidia-smi's clocks.sm (MHz) sampled every 100 ms while
    fn() runs back to back for about `seconds`."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(int(seconds / max(time.perf_counter() - t, 1e-5)), 1)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    vals = sorted(float(v) for v in out.split() if v.strip())
    # drop the first and last samples, taken while the loop ramps
    vals = vals[1:-1] or vals
    return vals[len(vals) // 2] if vals else float("nan")


def walk_sass_report(what, kernel, box_tests, fn):
    """Step 0 of a walk's redesign: per loop of `kernel`'s builds without
    counters, its SASS by kind and the ALU pipe's instructions per step
    (loops with the same counts on one line), and the ALU-pipe time
    estimate: ALU instructions per step x box tests / (SMs x 64 lanes per
    clock x the SM clock nvidia-smi reads while fn runs). Returns the
    largest estimate and the clock."""
    lib = _build.build()
    loops = sass_loops(lib, kernel)
    mhz = sm_clock_mhz(fn)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for name, ls in sorted(loops.items()):
        if "ILb1E" in name.split(kernel, 1)[1][:8]:
            continue  # the counting build
        groups = {}
        for i, lp in enumerate(ls):
            key = json.dumps([lp["whole"], lp["common"]])
            groups.setdefault(key, []).append(i)
        for key, idx in groups.items():
            whole, common = json.loads(key)
            ms = common["ALU pipe"] * box_tests / (sms * 64 * mhz * 1e6) * 1e3
            worst = max(worst, ms)
            print(f"{what} SASS {name[:80]} loops {idx}: whole "
                  f"{json.dumps(whole)}; common path {json.dumps(common)}; "
                  f"ALU-pipe time estimate {ms:.4f} ms at {mhz:.0f} MHz on "
                  f"{sms} SMs ({box_tests:.4g} box tests)")
    return worst, mhz


def walk_lines(name, cnt6, cnt7, t, k, has_env, w, h):
    """Phases 9 and 11: B6 / B7's registers, per-warp walk spread and
    B7's light targets per pixel (gated to [n_l, n_l + k * S], S its
    checkpoint spacing)."""
    print(f"{name} ptxas B6 gbuffer_bvh_kernel<COUNT,ENV,TEX>: "
          f"{ptxas_report('gbuffer_bvh.cu', 'gbuffer_bvh_kernel')}")
    print(f"{name} ptxas B7 ris_search_kernel<COUNT,ENV,Io>: "
          f"{ptxas_report('reuse_bvh.cu', 'ris_search_kernel')}; "
          f"reuse_walk_kernel<COUNT>: "
          f"{ptxas_report('reuse_bvh.cu', 'reuse_walk_kernel')}")
    for what, c in (("B6 box", cnt6[0]), ("B6 plane", cnt6[1]),
                    ("B7 box", cnt7[0]), ("B7 plane", cnt7[1])):
        mean, tile, strip = warp_spread(c, w, h)
        print(f"{name} {what} tests: {mean:.2f} per pixel, per-warp "
              f"maximum / mean {tile:.4f} on the launched 8x4 tiles "
              f"({strip:.4f} were the warps 32x1 strips)")
    n_l = light_count(t, has_env)
    seg = reuse.seg_cuda(t.n_lights, has_env)
    ev = cnt7[2]
    lo, hi, mean = int(ev.min()), int(ev.max()), float(ev.double().mean())
    print(f"{name} B7 light targets per pixel: mean {mean:.2f}, min {lo}, "
          f"max {hi} ({n_l} light rows, checkpoints every {seg}, bound "
          f"{n_l + k * seg}; the two-pass scan evaluated "
          f"{2 * t.light_rows(has_env)[1].shape[0]}); shared memory "
          f"{reuse.smem_bytes(t.n_lights, has_env, n_l, seg)} B per block")
    if lo < n_l or hi > n_l + k * seg:
        raise PhaseError(f"{name}: B7 evaluated {lo}-{hi} light targets per "
                         f"pixel, outside [{n_l}, {n_l + k * seg}]")


def phase_small_frames(arrays, cam, dev):
    """Three whole frames through the kernels vs the twins on the CPU."""
    cfg = render_config(arrays, width=256, height=64)
    out = {}
    for where in (dev, "cpu"):
        scene = convert.scene_from_numpy(arrays, where)
        state = renderer.init_state(cfg, cam, scene, device=where)
        for _ in range(3):
            state, frame = renderer.step(scene, state, cam, cfg)
        out[str(where)] = frame.cpu().numpy()
    got, ref = out[str(dev)], out["cpu"]
    mean_rel = abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-9)
    frac = float(np.isclose(got, ref, rtol=1e-3, atol=1e-6).mean())
    print(f"small frames (256x64, 3 frames) kernels vs CPU twins: "
          f"mean rel diff {mean_rel:.3g}, within rtol 1e-3: {frac:.5f}")
    if not np.isfinite(got).all() or mean_rel > 0.01 or frac < 0.99:
        raise PhaseError("small-frame parity failed")


def b1_bound(scene, gb, cam_vec, lcam_vec, cfg, has_env):
    """(least ms, what binds it, the walks' tests per pixel) of one B1
    call: the packs written and the tables read once; its two walks per
    pixel, counted by B6's and B7's COUNT builds on the same rays (B1a
    walks them bit for bit), and 2 light targets per light row."""
    t, bvh, r, k = scene.tables, scene.bvh, cfg.num_pixels, cfg.cdf_candidates
    _, cnt6 = gbuffer.gbuffer_cuda(
        cam_vec, lcam_vec, 1, bvh, width=cfg.width, height=cfg.height,
        aa_jitter=cfg.aa_jitter, single_sided=cfg.single_sided_lights,
        has_env=has_env, with_textures=cfg.with_textures, stats=True)
    _, cnt7 = reuse.candidates_cuda(gb, 1, t, bvh, width=cfg.width, k=k,
                                    single_sided=cfg.single_sided_lights,
                                    has_met=cfg.scene_has_metallic,
                                    has_env=has_env, stats=True)
    boxes, tris = (float(a.double().sum() + b.double().sum())
                   for a, b in zip(cnt6, cnt7))
    lights, psi = t.light_rows(has_env)
    n_tris, n_l = t.attr.shape[0], light_count(t, has_env)
    nbytes = r * (14 + 24 + 16) * 4 + table_bytes(
        t.planes[:n_tris], t.attr, t.mat, lights[:n_l], psi[:n_l],
        bvh.rows)
    pixel = r * (2 * n_l * FLOP_LIGHT + k * FLOP_CAND + FLOP_PIXEL
                 + FLOP_TEMPORAL)
    b = bound(nbytes, pixel + boxes * FLOP_BOX + tris * FLOP_PLANE)
    brute = bound(nbytes, pixel + r * 2 * n_tris * FLOP_PLANE)
    note = (f"{boxes / r:.2f} box + {tris / r:.2f} plane tests per pixel; "
            f"the every-row design's bound {brute[0]:.4f} ms ({brute[1]})")
    return b[0], b[1], note


def phase_main(name, scene, cfg, cam, dev, per_frame, warmup=WARMUP,
               timed=TIMED):
    """A main path through renderer.init_state / step; returns the launch
    counts of the run. per_frame: the expected launches of each kernel
    per frame."""
    reset_counts()
    state = renderer.init_state(cfg, cam, scene, device=dev)
    frame = None
    for _ in range(warmup):
        state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(timed):
        state, frame = renderer.step(scene, state, cam, cfg)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    dev_ms = start.elapsed_time(end) / timed
    MAIN_WALL[name] = wall_ms
    counts = read_counts()
    frames = warmup + timed
    expect = {k: per_frame.get(k, 0) * frames for k in counts}
    print(f"main path {name} launches {counts} (expected {expect})")
    if counts != expect:
        raise PhaseError(f"{name}: launch counts {counts} != {expect}")

    if tuple(frame.shape) != (3, cfg.num_pixels):
        raise PhaseError(f"frame shape {tuple(frame.shape)}")
    if not bool(torch.isfinite(frame).all()):
        raise PhaseError("frame has non-finite values")
    mean = float(frame.mean())
    if not mean > 0.0:
        raise PhaseError(f"frame is black (mean {mean})")
    img = renderer.frame_to_image(frame, cfg)
    if img.dtype != torch.uint8 or tuple(img.shape) != (cfg.height,
                                                        cfg.width, 3):
        raise PhaseError(f"image {img.dtype} {tuple(img.shape)}")
    shade = state.pt_pack[P_M] > 0
    m_mean = float(state.pt_pack[P_M][shade].mean())
    if not m_mean > 2 * cfg.cdf_candidates:
        raise PhaseError(f"temporal reuse not alive: mean M {m_mean}")
    tracer = "RESTIR_DI"
    if cfg.tracer == TracerType.RESTIR_GI:
        tracer = "RESTIR_GI"
        gm = state.gi_q[gi.Q_M]
        m_gi = float(gm[gm > 0].mean())
        ind_mean = float(state.accum_ind.mean())
        print(f"main path {name}: GI mean M {m_gi:.2f}, indirect mean "
              f"{ind_mean:.5f}")
        if not (m_gi > 2.0 and ind_mean > 0.0):
            raise PhaseError(f"{name}: GI reuse not alive (mean M {m_gi}, "
                             f"indirect mean {ind_mean})")
    fps = 1e3 / wall_ms
    den = {DenoiserType.NONE: "", DenoiserType.EAW: "+EAW",
           DenoiserType.SVGF: "+SVGF"}[cfg.denoiser]
    print(f"main path {name} {cfg.width}x{cfg.height} {tracer}{den}: "
          f"{wall_ms:.3f} ms/frame wall, {dev_ms:.3f} ms/frame device, "
          f"{fps:.3f} fps, {2 * cfg.num_pixels * fps / 1e6:.3f} Mrays/s; "
          f"frame mean {mean:.5f}, mean M {m_mean:.2f}, "
          f"image mean {float(img.float().mean()):.2f}")
    return counts


def profile_frames(name, scene, cfg, cam, dev, frames=4, with_scene=True,
                   tries=3, step=None, state=None):
    """Device busy time per frame, split into the port's kernels and
    PyTorch's own, and the largest kernels, from a torch.profiler trace of
    `frames` frames after 2 warm-up frames and one more profiled but
    discarded (the schedule's warm-up step: the device trace misses
    kernels of the first frame after it starts). Every frame launches the
    same port kernels, so a trace in which one of them has an event count
    that is not a multiple of `frames` lost events: it is taken again, up
    to `tries` times, and else reported as not measured. `step` (state
    -> state) and `state` replace renderer.step and init_state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if step is None:
        state = renderer.init_state(cfg, cam, scene if with_scene else None,
                                    device=dev)

        def step(s):
            return renderer.step(scene, s, cam, cfg)[0]

    for _ in range(2):
        state = step(state)
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            state = step(state)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for _ in range(frames):
                state = step(state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / frames
            prof.step()
        by_name, count = {}, {}
        for e in prof.events():
            # device events: kernels and copies, not the step annotations
            if (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("ProfilerStep")):
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / frames)
                if "at::native" not in e.name:
                    count[e.name] = count.get(e.name, 0) + 1
        lost = {k: n for k, n in count.items()
                if "(anonymous namespace)::" in k and n % frames}
        if by_name and not lost:
            break
        print(f"profile {name}: trace {attempt} of {tries} incomplete: "
              + "; ".join(f"{n} events of {k[:60]}" for k, n in lost.items())
              if by_name else
              f"profile {name}: trace {attempt} holds no device events")
    else:
        print(f"profile {name}: device busy share not measured")
        return
    busy = sum(by_name.values())
    torch_ms = sum(v for k, v in by_name.items() if "at::native" in k)
    print(f"profile {name}: {wall:.3f} ms/frame wall (profiled), device "
          f"busy {busy:.3f} ms/frame (port kernels {busy - torch_ms:.3f}, "
          f"PyTorch kernels {torch_ms:.3f}), idle share "
          f"{1.0 - busy / wall:.3f}")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {v:9.4f} ms/frame  {k[:90]}")


def load_hall():
    sys.path.insert(0, os.path.join(REPO, "scenes"))
    from make_hall import ensure_assets  # numpy only; writes scenes/generated

    t0 = time.perf_counter()
    ensure_assets()
    sf = parse_scene_file(os.path.join(REPO, "scenes", "hall.txt"))
    arrays = sf.build()
    print(f"hall: loaded and built (SAH + MTBVH) in "
          f"{time.perf_counter() - t0:.2f} s on the host: "
          f"{arrays.verts.shape[0]} triangles, {arrays.bounds_lo.shape[0]} "
          f"nodes, {arrays.light_verts.shape[0]} light triangles")
    return sf, arrays, sf.make_camera()


def sample_pixels(r, dev):
    """SAMPLE_TILES whole 1024-pixel tiles spread evenly over the frame."""
    tiles = np.linspace(0, r // TILE - 1, SAMPLE_TILES).round().astype(int)
    pix = (tiles[:, None] * TILE + np.arange(TILE)[None, :]).reshape(-1)
    return torch.as_tensor(pix, dtype=torch.int64, device=dev)


def walk_report(what, kernel_counts, pix, twin_boxes, twin_tris):
    """Print the kernel's mean tests per ray (whole frame) and the
    lockstep twin's agreement on the sample."""
    kb, kt = kernel_counts[0], kernel_counts[1]
    same_b = float((kb[pix] == twin_boxes).float().mean())
    same_t = float((kt[pix] == twin_tris).float().mean())
    print(f"{what}: kernel mean {float(kb.float().mean()):.2f} box + "
          f"{float(kt.float().mean()):.2f} triangle tests per ray over the "
          f"frame (max {int(kb.max())} boxes); on the sample kernel "
          f"{float(kb[pix].float().mean()):.2f} / "
          f"{float(kt[pix].float().mean()):.2f}, lockstep twin "
          f"{float(twin_boxes.float().mean()):.2f} / "
          f"{float(twin_tris.float().mean()):.2f}, per-ray equal on "
          f"{same_b:.5f} / {same_t:.5f}")
    if same_b < 0.99 or same_t < 0.99:
        raise PhaseError(f"{what}: the kernel's walk differs from the "
                         "lockstep twin's (table choice or culling)")


def phase_hall_kernels(scene, cfg, cam, dev, record):
    """B6, B7 and B1b on the hall at 1080p against their twins."""
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    bvh, t = scene.bvh, scene.tables
    cam2 = make_camera(position=(0.3, 4.2, 20.3),
                       rotation=(-90.5, -4.0, 0.0), fov_y=19.5)
    cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
    gkw = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
               single_sided=cfg.single_sided_lights)
    rkw = dict(k=cfg.cdf_candidates, single_sided=cfg.single_sided_lights,
               temporal=True, temporal_clamp=cfg.temporal_clamp,
               has_met=cfg.scene_has_metallic)
    zeros = torch.zeros((PT_CH, r), device=dev)
    # frame 0, then frame 1 from a moved camera: live temporal history
    gb0 = gbuffer.gbuffer_cuda(cv, cv, 0, bvh, **gkw)
    pt0 = reuse.reuse_cuda(gb0, zeros, 0, t, bvh, width=w, **rkw)
    gb_k, cnt6 = gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, stats=True, **gkw)
    rs_k, cnt7 = reuse.candidates_cuda(gb_k, 1, t, bvh, k=rkw["k"],
                                       single_sided=rkw["single_sided"],
                                       has_met=rkw["has_met"], width=w,
                                       stats=True)
    pt_k = fused_di.temporal_cuda(gb_k, rs_k, pt0, 1, k=rkw["k"],
                                  temporal_clamp=rkw["temporal_clamp"])
    pix = sample_pixels(r, dev)

    # B6 on the sample tiles
    gb_r = gbuffer.gbuffer_ref(cv2, cv, 1, bvh, pix=pix, **gkw)
    torch.cuda.synchronize()
    fails, st6 = parity.gb_report(gb_r, gb_k[:, pix])
    print(f"B6 gbuffer_bvh vs brute twin on {SAMPLE_TILES} tiles "
          f"({pix.numel()} px): {json.dumps(st6)}")
    gate(fails, "B6 disagrees with its twin")
    # B7 (+ B1b) on the sample tiles
    pt_r = reuse.reuse_ref(gb_k[:, pix], pt0, 1, t, pix=pix, **rkw)
    fails, st7 = parity.pt_report(pt_r, pt_k[:, pix])
    print(f"B7 reuse_bvh + B1b vs twin on the same tiles: {json.dumps(st7)}")
    gate(fails, "B7 disagrees with its twin")
    if float(pt_k[P_M].max()) <= cfg.cdf_candidates:
        raise PhaseError("hall temporal merge inactive")
    # B1b alone over the whole frame, on the kernel's candidates
    def b1b_twin():
        return fused_di.temporal_pixels(
            gb_k, rs_k[RS_LI:RS_LI + 3], rs_k[RS_WI:RS_WI + 3],
            rs_k[RS_DIST], rs_k[RS_W], torch.arange(r, device=dev), 1, pt0,
            k=rkw["k"], temporal=True, temporal_clamp=rkw["temporal_clamp"])

    pt_tw = b1b_twin()
    close = parity.close_fraction(pt_tw, pt_k, 1e-6, 0.0)
    print(f"B1b temporal vs twin over the frame: exact-close {close:.6f}")
    if close < 0.9999:
        raise PhaseError(f"B1b disagrees with its twin on {1 - close:.6f}")

    # the walks' work: kernel counters over the frame, lockstep on tiles
    o = tuple(cv2[i].expand(pix.numel()) for i in range(3))
    d = tuple(gb_k[G_DIR + i][pix] for i in range(3))
    _, _, _, _, wb, wt = bvh_walk.closest_walk(bvh, o, d)
    walk_report("B6 closest-hit walk", cnt6, pix, wb, wt)
    wi = tuple(rs_k[RS_WI + i][pix] for i in range(3))
    o = tuple(gb_k[G_POS + i][pix] + wi[i] * 1e-5 for i in range(3))
    limit = rs_k[RS_DIST][pix] * (1.0 - 1e-3) - 1e-4
    _, wb, wt = bvh_walk.occluded_walk(bvh, o, wi, limit, gb_k[G_PRIM][pix])
    walk_report("B7 any-hit walk", cnt7, pix, wb, wt)
    walk_lines("hall", cnt6, cnt7, t, rkw["k"], False, w, h)

    # times at 1080p: kernels by CUDA events, twins once over the frame
    ms6 = cuda_ms(lambda: gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, **gkw), 10)
    ms7 = cuda_ms(lambda: reuse.candidates_cuda(
        gb_k, 1, t, bvh, k=rkw["k"], has_met=rkw["has_met"], width=w), 10)
    ms1b = cuda_ms(lambda: fused_di.temporal_cuda(gb_k, rs_k, pt0, 1), 20)
    ms1b_ref = cuda_ms(b1b_twin, 1)
    ms6_ref = cuda_ms(lambda: gbuffer.gbuffer_ref(cv2, cv, 1, bvh, **gkw),
                      1, warmup=False)
    ms7_ref = cuda_ms(lambda: reuse.reuse_ref(gb_k, pt0, 1, t, **rkw), 1,
                      warmup=False)
    tables6 = table_bytes(bvh.planes, bvh.attr, bvh.mat, bvh.rows)
    print(f"hall MTBVH tables on the card: {tables6 / 2**20:.1f} MiB "
          f"(planes, attributes, materials, node rows with their boxes)")
    b6 = walk_bound6(bvh, r, cnt6)
    b7 = walk_bound7(t, bvh, r, rkw["k"], cnt7, False)
    b7_two = walk_bound7(t, bvh, r, rkw["k"], cnt7, False, passes=2)
    # B1b: gb 8 + rs 8 + the history's 14 channels read, pt 16 written
    b1b = bound(r * (8 + 8 + 14 + PT_CH) * 4, r * FLOP_TEMPORAL)
    record["gbuffer_bvh"] = dict(
        max_abs_err=max(st6["pos_max_abs_err"], st6["norm_max_abs_err"]),
        ms=ms6, plain_ms=ms6_ref, bound_ms=b6[0], bound_by=b6[1],
        library_ms=None)
    record["reuse_bvh"] = dict(
        max_abs_err=st7["weight_max_abs_err"], ms=ms7, plain_ms=ms7_ref,
        bound_ms=b7[0], bound_by=b7[1], library_ms=None)
    print(f"hall B6 gbuffer_bvh: kernel {ms6:.4f} ms, twin {ms6_ref:.1f} ms,"
          f" bound {b6[0]:.4f} ms ({b6[1]})")
    print(f"hall B7 reuse_bvh: kernel {ms7:.4f} ms, twin (with B1b) "
          f"{ms7_ref:.1f} ms, bound {b7[0]:.4f} ms ({b7[1]}; the two-pass "
          f"scan's {b7_two[0]:.4f})")
    print(f"hall B1b temporal: kernel {ms1b:.4f} ms, twin {ms1b_ref:.2f} "
          f"ms, bound {b1b[0]:.4f} ms ({b1b[1]})")


def phase_svgf_kernels(cfg, gb, dev, record):
    """B5, the variance kernels and B4 (all levels) against their twins
    on B1's G-buffer gb with a random demodulated colour and history."""
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    g = np.random.default_rng(5)
    prev = torch.as_tensor(g.random((svgf.SV_CH, r), dtype=np.float32),
                           device=dev)
    prev[svgf.SV_HIST] = torch.as_tensor(
        g.integers(0, 8, r).astype(np.float32), device=dev)
    # prim and normal history of this frame, so reprojected pixels blend
    prev[svgf.SV_PRIM] = gb[fused_di.G_PRIMR]
    prev[svgf.SV_NORM:svgf.SV_NORM + 3] = gb[fused_di.G_NORM:
                                             fused_di.G_NORM + 3]
    color = torch.as_tensor(g.random((3, r), dtype=np.float32), device=dev)

    sv_k = svgf.svgf_temporal_cuda(gb, color, prev)
    sv_r = svgf.svgf_temporal_ref(gb, color, prev)
    torch.cuda.synchronize()
    close = parity.close_fraction(sv_r, sv_k, 1e-6, 0.0)
    err5 = float((sv_r - sv_k).abs().max())
    blended = float((sv_k[svgf.SV_HIST] > 0).float().mean())
    print(f"B5 svgf_temporal vs twin: within rtol 1e-6 {close:.6f}, max abs "
          f"err {err5:.3g}; history blended on {blended:.4f} of pixels")
    if close < 0.9999 or blended < 0.1:
        raise PhaseError(f"B5 disagrees with its twin ({close:.6f}) or "
                         f"never blends ({blended:.4f})")
    ms5 = cuda_ms(lambda: svgf.svgf_temporal_cuda(gb, color, prev), 20)
    ms5_ref = cuda_ms(lambda: svgf.svgf_temporal_ref(gb, color, prev), 5)
    b5 = bound(r * (3 + 6 + 10 + svgf.SV_CH) * 4, r * FLOP_B5)
    record["svgf_temporal"] = dict(max_abs_err=err5, ms=ms5,
                                   plain_ms=ms5_ref, bound_ms=b5[0],
                                   bound_by=b5[1], library_ms=None)
    print(f"B5 svgf_temporal: kernel {ms5:.4f} ms, twin {ms5_ref:.4f} ms, "
          f"bound {b5[0]:.4f} ms ({b5[1]})")

    vkw = dict(width=w, height=h)
    mom = sv_k[svgf.SV_M1:svgf.SV_M1 + 3]  # the pack's moment rows, in place
    var_k, fv0_k = svgf.estimate_variance(mom, **vkw)
    var_r = denoiser.svgf_estimate_variance(mom.reshape(3, h, w))
    fv0_r = denoiser.svgf_filter_variance(var_r).reshape(r)
    var_r = var_r.reshape(r)
    fv_k = svgf.filter_variance(var_k, **vkw)
    fv_r = denoiser.svgf_filter_variance(var_k.reshape(h, w)).reshape(r)
    closes = (parity.close_fraction(var_r[None], var_k[None], 1e-6, 1e-7),
              parity.close_fraction(fv0_r[None], fv0_k[None], 1e-6, 1e-7),
              parity.close_fraction(fv_r[None], fv_k[None], 1e-6, 1e-7))
    exact = [float(bits_equal(a, b).float().mean()) for a, b in
             ((var_k, var_r), (fv0_k, fv0_r), (fv_k, fv_r))]
    err_v = max(float((var_r - var_k).abs().max()),
                float((fv0_r - fv0_k).abs().max()),
                float((fv_r - fv_k).abs().max()))
    print(f"variance kernels vs twins (estimate, its level-0 prefilter, "
          f"a later prefilter): within rtol 1e-6 "
          + ", ".join(f"{c:.6f}" for c in closes) + "; bit for bit "
          + ", ".join(f"{e:.6f}" for e in exact)
          + f"; max abs err {err_v:.3g}")
    if min(closes) < 0.9999:
        raise PhaseError("the variance kernels disagree with their twins")

    def one_var_each_ref():
        v = denoiser.svgf_estimate_variance(mom.reshape(3, h, w))
        denoiser.svgf_filter_variance(v)

    # these kernels are shorter than their wrappers' host time, so the
    # kernel's time is the profiler's device time; CUDA events around
    # back-to-back calls (printed beside) time the host
    ms_v = device_ms(lambda: svgf.estimate_variance(mom, **vkw), 20,
                     "svgf_variance_kernel")
    ms_f = device_ms(lambda: svgf.filter_variance(var_k, **vkw), 20,
                     "svgf_filter_variance_kernel")
    ev_v = cuda_ms(lambda: svgf.estimate_variance(mom, **vkw), 20)
    ev_f = cuda_ms(lambda: svgf.filter_variance(var_k, **vkw), 20)
    ms_v_ref = cuda_ms(one_var_each_ref, 5)
    # the moments read, the variance and its prefilter written
    bv = bound(r * (3 + 2) * 4, r * FLOP_VAR)
    bf = bound(r * (1 + 1) * 4, r * FLOP_PREFILTER)
    record["svgf_variance"] = dict(max_abs_err=err_v, ms=ms_v,
                                   plain_ms=ms_v_ref, bound_ms=bv[0],
                                   bound_by=bv[1], library_ms=None)
    print(f"variance estimate + level-0 prefilter (one launch): kernel "
          f"{ms_v:.4f} ms on the device ({ev_v:.4f} ms per call by CUDA "
          f"events), twins {ms_v_ref:.4f} ms, bound {bv[0]:.4f} ms "
          f"({bv[1]}); prefilter of a later level: kernel {ms_f:.4f} ms on "
          f"the device ({ev_f:.4f} by events), bound {bf[0]:.4f} ms "
          f"({bf[1]})")

    akw = dict(width=w, height=h, sig_l=cfg.sig_luminance,
               sig_n=cfg.svgf_sig_normal, sig_d=cfg.svgf_sig_depth)
    col, var, fv = sv_k[svgf.SV_COL:svgf.SV_COL + 3].contiguous(), var_k, \
        fv0_k
    err4, ms4, ms4_ref = 0.0, [], []
    for level in range(cfg.eaw_levels):
        if level > 0:
            fv = svgf.filter_variance(var, **vkw)
        ck, vk = atrous.atrous_svgf_cuda(col, var, fv, gb, level=level,
                                         **akw)
        cr, vr = atrous.atrous_svgf_ref(col, var, fv, gb, level=level, **akw)
        fc = parity.close_fraction(cr, ck, 1e-5, 1e-6)
        fvar = parity.close_fraction(vr[None], vk[None], 1e-5, 1e-6)
        err = max(float((cr - ck).abs().max()), float((vr - vk).abs().max()))
        err4 = max(err4, err)
        exact = float((bits_equal(ck, cr).all(0)
                       & bits_equal(vk, vr)).float().mean())
        print(f"B4 level {level} vs twin: colour close {fc:.6f}, variance "
              f"close {fvar:.6f}, exact lanes {exact:.6f}, max abs err "
              f"{err:.3g}")
        if min(fc, fvar) < 0.999:
            raise PhaseError(f"B4 level {level} disagrees with its twin")
        c_in, v_in = col, var
        ms4.append(cuda_ms(lambda: atrous.atrous_svgf_cuda(
            c_in, v_in, fv, gb, level=level, **akw), 20))
        ms4_ref.append(cuda_ms(lambda: atrous.atrous_svgf_ref(
            c_in, v_in, fv, gb, level=level, **akw), 2))
        col, var = ck, vk
    # colour 3 + variance + fv + guide 7 read, colour 3 + variance written
    b4 = bound(r * (3 + 1 + 1 + 7 + 4) * 4, r * 25 * FLOP_B4_TAP)
    record["atrous_svgf"] = dict(max_abs_err=err4, ms=float(np.mean(ms4)),
                                 plain_ms=float(np.mean(ms4_ref)),
                                 bound_ms=b4[0], bound_by=b4[1],
                                 library_ms=None)
    print("B4 atrous_svgf per level: kernel "
          + ", ".join(f"{x:.4f}" for x in ms4) + " ms; twin "
          + ", ".join(f"{x:.4f}" for x in ms4_ref) + f" ms; bound "
          f"{b4[0]:.4f} ms ({b4[1]})")


def phase_env_tex(name, arrays, camkw, flags, dev, record):
    """B1 with its env or texture branch against its twin, B6 + B7 + B1b
    against B1 (bit for bit), and the scene's main path, at 1080p."""
    cfg = render_config(arrays, has_env_map=flags.get("has_env", False),
                        with_textures=flags.get("with_textures", False))
    cam = make_camera(**camkw)
    pos = camkw["position"]
    cam2 = make_camera(**{**camkw, "position": (pos[0] + 0.25, pos[1],
                                                pos[2])})
    scene = convert.scene_from_numpy(arrays, dev)
    r = cfg.num_pixels
    t, bvh = scene.tables, scene.bvh
    cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
    kw = dict(width=cfg.width, height=cfg.height, aa_jitter=cfg.aa_jitter,
              single_sided=cfg.single_sided_lights, k=cfg.cdf_candidates,
              temporal=True, temporal_clamp=cfg.temporal_clamp,
              has_met=cfg.scene_has_metallic, **flags)
    zeros = torch.zeros((PT_CH, r), device=dev)
    _, pt0 = fused_di.di_resident_cuda(cv, cv, 0, zeros, t, bvh, **kw)
    gb_k, pt_k = fused_di.di_resident_cuda(cv2, cv, 1, pt0, t, bvh, **kw)
    gb_r, pt_r = fused_di.di_resident_ref(cv2, cv, 1, pt0, t, **kw)
    # the twin's RIS, visibility and merge on the kernel's G-buffer: a
    # motion index that flips by an ulp moves its tile's window start
    # and with it the merges of the whole tile, which on a sky-lit frame
    # (tiles with few hits) outweighs the stage under test
    rkw = {k: v for k, v in kw.items()
           if k not in ("width", "height", "aa_jitter", "with_textures")}
    pt_rk = reuse.reuse_ref(gb_k, pt0, 1, t, **rkw)
    torch.cuda.synchronize()
    _, chain = parity.pt_report(pt_r, pt_k)
    print(f"B1 {name}: whole-chain twin's reuse pack vs kernel (not "
          f"gated): {json.dumps(chain)}")
    fails, stats = parity.gb_pt_report(gb_r, pt_rk, gb_k, pt_k)
    hit = gb_r[fused_di.G_PRIM] == gb_k[fused_di.G_PRIM]
    alb = slice(fused_di.G_ALB, fused_di.G_ALB + 3)
    stats["albedo_close"] = parity.close_fraction(
        gb_r[alb][:, hit], gb_k[alb][:, hit], 1e-4, 1e-5)
    print(f"B1 {name} ({scene.num_tris} triangles, "
          f"{t.light_rows(cfg.has_env_map)[1].shape[0]} light rows) vs twin "
          f"at {cfg.width}x{cfg.height} (reuse pack from the kernel's "
          f"G-buffer): {json.dumps(stats)}")
    gate(fails, f"B1 ({name}) disagrees with its twin")
    if stats["albedo_close"] < 0.99:
        raise PhaseError(f"B1 ({name}) albedo disagrees with its twin")
    if cfg.has_env_map:
        env_win = float((pt_k[fused_di.P_DIST] > 1e7).float().mean())
        print(f"B1 {name}: env winners on {env_win:.4f} of pixels, miss "
              f"{float(gb_k[fused_di.G_MISS].mean()):.4f}")
        if not env_win > 0.0:
            raise PhaseError("no env-tile winner on the env scene")
    ms = cuda_ms(lambda: fused_di.di_resident_cuda(cv2, cv, 1, pt0, t, bvh,
                                                   **kw), 10)
    ms_ref = cuda_ms(lambda: fused_di.di_resident_ref(cv2, cv, 1, pt0, t,
                                                      **kw), 2)
    b1 = b1_bound(scene, gb_k, cv2, cv, cfg, cfg.has_env_map)
    record[f"fused_di_{name}"] = dict(
        max_abs_err=max(stats["pos_max_abs_err"],
                        stats["weight_max_abs_err"]),
        ms=ms, plain_ms=ms_ref, bound_ms=b1[0], bound_by=b1[1],
        library_ms=None)
    print(f"B1 {name}: kernel {ms:.4f} ms, twin {ms_ref:.4f} ms, bound "
          f"{b1[0]:.4f} ms ({b1[1]}; {b1[2]})")

    has_env = flags.get("has_env", False)
    gb = gbuffer.gbuffer_cuda(cv2, cv, 1, scene.bvh, width=cfg.width,
                              height=cfg.height, aa_jitter=cfg.aa_jitter,
                              single_sided=cfg.single_sided_lights,
                              has_env=has_env,
                              with_textures=flags.get("with_textures",
                                                      False))
    pt = reuse.reuse_cuda(gb, pt0, 1, t, scene.bvh, k=cfg.cdf_candidates,
                          single_sided=cfg.single_sided_lights,
                          temporal_clamp=cfg.temporal_clamp,
                          has_met=cfg.scene_has_metallic, has_env=has_env,
                          width=cfg.width)
    same = bool(torch.equal(gb, gb_k)) and bool(torch.equal(pt, pt_k))
    print(f"MTBVH (B6 + B7 + B1b) vs B1 on {name}: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise PhaseError(f"B6 + B7 + B1b differ from B1 on {name}")
    counts = phase_main(name, scene, cfg, cam, dev, {
        "fused_di": 2, "spatial": 1, "atrous_eaw": cfg.eaw_levels})
    profile_frames(name, scene, cfg, cam, dev)
    return counts["fused_di"]


def phase_sky_hall(sf, cam, dev):
    """The hall under an equirect sky: B6 / B7 (640 light rows) against
    their twins on the sample tiles, then its main path."""
    t0 = time.perf_counter()
    sf.env_map = gradient_sky(512, 1024)
    arrays = sf.build()
    print(f"hall under a sky: built in {time.perf_counter() - t0:.2f} s")
    cfg = render_config(arrays, has_env_map=True)
    scene = convert.scene_from_numpy(arrays, dev)
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    bvh, t = scene.bvh, scene.tables
    cam2 = make_camera(position=(0.3, 4.2, 20.3),
                       rotation=(-90.5, -4.0, 0.0), fov_y=19.5)
    cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
    gkw = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
               single_sided=cfg.single_sided_lights, has_env=True)
    rkw = dict(k=cfg.cdf_candidates, single_sided=cfg.single_sided_lights,
               temporal=True, temporal_clamp=cfg.temporal_clamp,
               has_met=cfg.scene_has_metallic, has_env=True)
    zeros = torch.zeros((PT_CH, r), device=dev)
    gb0 = gbuffer.gbuffer_cuda(cv, cv, 0, bvh, **gkw)
    pt0 = reuse.reuse_cuda(gb0, zeros, 0, t, bvh, width=w, **rkw)
    gb_k = gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, **gkw)
    pt_k = reuse.reuse_cuda(gb_k, pt0, 1, t, bvh, width=w, **rkw)
    pix = sample_pixels(r, dev)
    gb_r = gbuffer.gbuffer_ref(cv2, cv, 1, bvh, pix=pix, **gkw)
    torch.cuda.synchronize()
    fails, st6 = parity.gb_report(gb_r, gb_k[:, pix])
    alb = slice(fused_di.G_ALB, fused_di.G_ALB + 3)
    st6["albedo_close"] = parity.close_fraction(gb_r[alb], gb_k[alb][:, pix],
                                                1e-6, 0.0)
    print(f"sky hall B6 vs brute twin on {SAMPLE_TILES} tiles: "
          f"{json.dumps(st6)}")
    gate(fails, "B6 (sky hall) disagrees with its twin")
    pt_r = reuse.reuse_ref(gb_k[:, pix], pt0, 1, t, pix=pix, **rkw)
    fails, st7 = parity.pt_report(pt_r, pt_k[:, pix])
    env_win = float((pt_k[fused_di.P_DIST] > 1e7).float().mean())
    print(f"sky hall B7 + B1b vs twin on the same tiles: {json.dumps(st7)}; "
          f"env winners on {env_win:.4f} of the frame")
    gate(fails, "B7 (sky hall) disagrees with its twin")
    l_pad = t.light_rows(True)[1].shape[0]
    ms6 = cuda_ms(lambda: gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, **gkw), 10)
    ms7 = cuda_ms(lambda: reuse.candidates_cuda(
        gb_k, 1, t, bvh, k=rkw["k"], has_met=rkw["has_met"], has_env=True,
        width=w), 10)
    _, cnt6 = gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, stats=True, **gkw)
    _, cnt7 = reuse.candidates_cuda(gb_k, 1, t, bvh, k=rkw["k"],
                                    has_met=rkw["has_met"], has_env=True,
                                    width=w, stats=True)
    b6 = walk_bound6(bvh, r, cnt6)
    b7 = walk_bound7(t, bvh, r, rkw["k"], cnt7, True)
    b7_two = walk_bound7(t, bvh, r, rkw["k"], cnt7, True, passes=2)
    print(f"sky hall B6 gbuffer_bvh: kernel {ms6:.4f} ms, bound "
          f"{b6[0]:.4f} ms ({b6[1]}); B7 reuse_bvh ({l_pad} light rows): "
          f"kernel {ms7:.4f} ms, bound {b7[0]:.4f} ms ({b7[1]}; the "
          f"two-pass scan's {b7_two[0]:.4f}); shadow "
          f"walk {float(cnt7[0].double().mean()):.2f} box + "
          f"{float(cnt7[1].double().mean()):.2f} triangle tests per ray")
    walk_lines("sky hall", cnt6, cnt7, t, rkw["k"], True, w, h)
    phase_main("sky hall", scene, cfg, cam, dev, {
        "gbuffer_bvh": 1, "reuse_bvh": 1, "ris_search": 1, "temporal": 1,
        "spatial": 1, "atrous_eaw": cfg.eaw_levels})
    profile_frames("sky hall", scene, cfg, cam, dev)


def bits_equal(a, b):
    """Elementwise: a and b hold the same bits (float32 or int32)."""
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return a == b


def walk_line(what, counts, lanes=None):
    """Print a walk's box and plane tests per walked ray (kernel
    counters [2, R]) and the per-warp maxima against the mean; return the
    summed (box tests, plane tests)."""
    c = counts.to(torch.float64)
    boxes, tests = float(c[0].sum()), float(c[1].sum())
    n = max(int(lanes.sum()) if lanes is not None else c.shape[1], 1)
    mean = c.sum(1) / c.shape[1]
    warp = c.reshape(2, -1, 32).amax(2).mean(1)
    print(f"{what} walks: {boxes / n:.2f} box and {tests / n:.2f} plane "
          f"tests per walked ray ({n} rays); per warp of 32 lanes: mean of "
          f"the max box tests {float(warp[0]):.2f} "
          f"({float(warp[0] / mean[0]):.3f}x the lane mean), of the max "
          f"plane tests {float(warp[1]):.2f} "
          f"({float(warp[1] / mean[1]):.3f}x)")
    return boxes, tests


def walk_spread(what, counts, live=None):
    """Phase 19: a B13 walk's box tests per lane and their per-warp
    maximum / mean on 8x4-pixel tiles beside 32x1 strips (lanes that are
    not walked count 0: a warp waits on them as on its longest lane), and
    the share of live lanes. A warp's walk loop runs its longest lane, so
    the ratio bounds what refilling idle lanes with new rays could save."""
    mean, tile, strip = warp_spread(counts[0], WIDTH, HEIGHT)
    share = 1.0 if live is None else float(live.float().mean())
    print(f"{what}: {mean:.2f} box tests per lane, live share "
          f"{share:.4f}; per-warp maximum / mean {tile:.4f} on 8x4 tiles, "
          f"{strip:.4f} on 32x1 strips")


def b12_mask_report(scene, cam, dev, base):
    """PT-full's share of dead lanes at each bounce (B12 does not walk
    them), and PT_FULL / PT_INDIRECT frames with B12's mask of live lanes
    equal bit for bit to frames of B12 walking every lane with the dead
    lanes' primitive and distance masked afterwards."""
    real = hits.primary_hit
    dead = []

    def masked(trv, prim_attr, mat_attr, o, d, active=None, geom=None):
        if active is not None:
            dead.append(float((~active).float().mean()))
        return real(trv, prim_attr, mat_attr, o, d, active, geom)

    def unmasked(trv, prim_attr, mat_attr, o, d, active=None, geom=None):
        prim, dist, *rest = real(trv, prim_attr, mat_attr, o, d, None, geom)
        if active is not None:
            prim = torch.where(active, prim, -1)
            dist = torch.where(active, dist, torch.inf)
        return (prim, dist, *rest)

    for name, tracer in (("PT_FULL", TracerType.PT_FULL),
                         ("PT_INDIRECT", TracerType.PT_INDIRECT)):
        cfg = base.replace(tracer=tracer, trace_depth=5)
        frames = []
        for spy in (masked, unmasked):
            hits.primary_hit = spy
            try:
                state = renderer.init_state(cfg, cam, scene, device=dev)
                state, frame = renderer.step(scene, state, cam, cfg)
            finally:
                hits.primary_hit = real
            frames.append(frame)
        if tracer == TracerType.PT_FULL:
            print(f"PT-full ({cfg.width}x{cfg.height}, depth 5) share of "
                  "dead lanes B12 does not walk, by bounce 1-5: "
                  + ", ".join(f"{x:.4f}" for x in dead))
        same = torch.equal(frames[0], frames[1])
        print(f"{name} frame with / without B12's mask of live lanes: "
              f"{'equal bit for bit' if same else 'DIFFERENT'} (mean "
              f"{float(frames[0].mean()):.6f})")
        if not same:
            raise PhaseError(f"{name}: B12's mask changes the frame")


def phase_general_kernels(scene, cam, dev, record, launches, flags):
    """B12, B11 (closest and any hit) and B10 against their twins at 1080p
    on the headline scene, and the ray-query entry point that launches
    B11's closest hit."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, tracer=TracerType.PT_FULL)
    r = cfg.num_pixels
    t = scene.tables
    n_tris = scene.num_tris
    planes = t.planes[:n_tris]  # the rows that hold triangles
    g = general_rays(scene, cam, dev)
    trv, attr, mats = g["trv"], scene.prim_attr, scene.mat_attr
    walk_tables = table_bytes(planes, trv.rows)

    # B12 on frame 1's camera rays and on PT-full's first bounce rays,
    # bit for bit against primary_ref on the card; today's gates are the
    # floor
    def b12(what, o, d, active):
        k = hits.primary_cuda(trv, attr, mats, o, d, active)
        kc, counts = hits.primary_cuda(trv, attr, mats, o, d, active,
                                       stats=True)
        ref = hits.primary_ref(trv, attr, mats, o, d, active)
        torch.cuda.synchronize()
        same = k[hits.CH_PRIM] == ref[hits.CH_PRIM]
        hit = same & (ref[hits.CH_PRIM] >= 0)
        close = float(torch.isclose(k[:, hit], ref[:, hit], rtol=2e-4,
                                    atol=1e-6).all(0).float().mean())
        lanes_eq = bits_equal(k, ref).all(0)
        exact = int(lanes_eq.sum()) / r
        chans = bits_equal(k, ref).all(1)
        print(f"B12 primary_hit vs twin on {what}: exact lanes {exact:.7f} "
              f"(channels not exact: {torch.nonzero(~chans)[:, 0].tolist()}"
              f"), primitive match {float(same.float().mean()):.6f}, "
              f"matched lanes within rtol 2e-4 {close:.6f}, hits "
              f"{float(hit.float().mean()):.4f}, max abs err "
              f"{max_err(k, ref):.3g}")
        if float(same.float().mean()) < 0.998 or close < 0.999:
            raise PhaseError(f"B12 disagrees with its twin on {what}")
        if not bool(lanes_eq.all()) or not torch.equal(kc, k):
            raise PhaseError(f"B12 is not bit for bit its twin on {what}")
        return k, ref, counts

    o, d = g["o"], g["d"]
    k12, r12, c12 = b12(f"{WIDTH}x{HEIGHT} camera rays", o, d, None)
    boxes, tests = walk_line("B12 camera-ray", c12)
    ms = cuda_ms(lambda: hits.primary_cuda(trv, attr, mats, o, d), 10)
    ms_ref = cuda_ms(lambda: hits.primary_ref(trv, attr, mats, o, d), 2)
    b = bound(r * (6 + hits.PRIMARY_CH) * 4 + walk_tables
              + table_bytes(attr, mats),
              boxes * FLOP_BOX + tests * FLOP_PLANE + r * FLOP_B12_EPI)
    record["primary_hit"] = dict(max_abs_err=max_err(k12, r12), ms=ms,
                                 plain_ms=ms_ref, bound_ms=b[0],
                                 bound_by=b[1], library_ms=None)
    print(f"B12 primary_hit: kernel {ms:.4f} ms, twin {ms_ref:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}), {n_tris} triangles")
    ro, rd, live = g["ro"], g["rd"], g["bounce_live"]
    _, _, cb = b12("PT-full's first bounce rays (live lanes)", ro, rd, live)
    boxes_b, tests_b = walk_line("B12 bounce-ray", cb, live)
    ms_b = cuda_ms(lambda: hits.primary_cuda(trv, attr, mats, ro, rd, live),
                   10)
    ms_all = cuda_ms(lambda: hits.primary_cuda(trv, attr, mats, ro, rd), 10)
    b_b = bound(r * (6 + hits.PRIMARY_CH) * 4 + r + walk_tables
                + table_bytes(attr, mats),
                boxes_b * FLOP_BOX + tests_b * FLOP_PLANE
                + r * FLOP_B12_EPI)
    print(f"B12 primary_hit on the bounce rays: kernel {ms_b:.4f} ms with "
          f"the mask ({float(live.float().mean()):.4f} live), {ms_all:.4f} "
          f"ms walking every lane; bound {b_b[0]:.4f} ms ({b_b[1]})")

    # B11 closest hit on those bounce rays, every lane
    pk, dk, bk = hits.closest_cuda(trv, ro, rd)
    pc, dc, bc, c11 = hits.closest_cuda(trv, ro, rd, stats=True)
    pr, dr, br = intersect_bf.intersect_closest_bf(trv.tri_xform, ro, rd)
    torch.cuda.synchronize()
    hit = pr >= 0
    same = float((pk == pr).float().mean())
    lanes_eq = bits_equal(pk, pr) & (~hit | (
        bits_equal(dk, dr) & bits_equal(bk, br).all(1)))
    exact = int(lanes_eq.sum()) / r
    both = (pk == pr) & hit
    close = float((torch.isclose(dk[both], dr[both], rtol=2e-4)
                   & torch.isclose(bk[both], br[both], rtol=2e-4,
                                   atol=1e-5).all(1)).float().mean())
    err11 = float((dk[both] - dr[both]).abs().max())
    miss_ok = bool(torch.isinf(dk[~hit]).all() and (bk[~hit] == 0).all())
    print(f"B11 closest_hit vs twin on {r} bounce rays (every lane): exact "
          f"lanes {exact:.7f} (prim on every lane, dist and barycentrics "
          f"on hits), primitive match {same:.6f}, matched hits within rtol "
          f"2e-4 {close:.6f}, max abs dist err {err11:.3g}, misses inf / 0 "
          f"{miss_ok}")
    if same < 0.998 or close < 0.999:
        raise PhaseError("B11 disagrees with its twin")
    if not bool(lanes_eq.all()) or not miss_ok or not (
            torch.equal(pc, pk) and torch.equal(dc, dk)
            and torch.equal(bc, bk)):
        raise PhaseError("B11's closest hit is not bit for bit its twin")
    boxes, tests = walk_line("B11 closest-hit", c11)
    ms = cuda_ms(lambda: hits.closest_cuda(trv, ro, rd), 10)
    ms_ref = cuda_ms(lambda: intersect_bf.intersect_closest_bf(
        trv.tri_xform, ro, rd), 2)
    b = bound(r * (24 + 16) + walk_tables,
              boxes * FLOP_BOX + tests * FLOP_PLANE)
    record["closest_hit"] = dict(max_abs_err=err11, ms=ms, plain_ms=ms_ref,
                                 bound_ms=b[0], bound_by=b[1],
                                 library_ms=None)
    print(f"B11 closest_hit: kernel {ms:.4f} ms, twin {ms_ref:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]})")
    # No render path casts closest-hit rays on the card (bounces go through
    # B12), so B11's closest hit is driven through the port's ray-query
    # entry point, a main path of its own.
    reset_counts()
    hit = intersect.intersect_closest(trv, ro, rd)
    torch.cuda.synchronize()
    counts = read_counts()
    expect = {k: int(k == "closest_hit") for k in counts}
    print(f"main path ray query (intersect_closest on {r} bounce rays) "
          f"launches {counts}")
    if counts != expect:
        raise PhaseError(f"ray query: launch counts {counts} != {expect}")
    if not torch.equal(hit.prim_id, pk):
        raise PhaseError("ray query: intersect_closest != B11's closest hit")
    launches["closest_hit"] = counts["closest_hit"]

    # ... and its any-hit variant on NEE segments from the camera hits
    pos, target, shoot = g["pos"], g["target"], g["shoot"]
    occ_k = hits.any_cuda(trv, pos, target, shoot)
    occ_c, c_any = hits.any_cuda(trv, pos, target, shoot, stats=True)
    occ_r = intersect_bf.test_occlusion_bf(trv.tri_xform, pos, target,
                                           shoot)
    torch.cuda.synchronize()
    exact = int((occ_k == occ_r).sum()) / r
    agree = float((occ_k == occ_r)[shoot].float().mean())
    print(f"B11 any hit vs twin on {int(shoot.sum())} NEE segments: exact "
          f"lanes {exact:.7f} (every lane), agree on live segments "
          f"{agree:.6f}, occluded {float(occ_k[shoot].float().mean()):.4f}")
    if agree < 0.998:
        raise PhaseError("B11's any hit disagrees with its twin")
    if not torch.equal(occ_k, occ_r) or not torch.equal(occ_c, occ_k):
        raise PhaseError("B11's any hit is not its twin's on every lane")
    boxes, tests = walk_line("B11 any-hit", c_any, shoot)
    ms_any = cuda_ms(lambda: hits.any_cuda(trv, pos, target, shoot), 10)
    ms_any_ref = cuda_ms(lambda: intersect_bf.test_occlusion_bf(
        trv.tri_xform, pos, target, shoot), 2)
    b_any = bound(r * (24 + 2) + walk_tables,
                  boxes * FLOP_BOX + tests * FLOP_PLANE)
    record["any_hit"] = dict(
        max_abs_err=float((occ_k != occ_r).any()), ms=ms_any,
        plain_ms=ms_any_ref, bound_ms=b_any[0], bound_by=b_any[1],
        library_ms=None)
    print(f"B11 any_hit: kernel {ms_any:.4f} ms, twin {ms_any_ref:.4f} ms, "
          f"bound {b_any[0]:.4f} ms ({b_any[1]})")
    b12_mask_report(scene, cam, dev, RenderConfig(
        width=WIDTH, height=HEIGHT, **flags))

    # B10 on the general G-buffer
    dcfg = cfg.replace(tracer=TracerType.RESTIR_DI)
    pack, shade = b10_input(scene, cam, dev)
    kw = dict(k=dcfg.cdf_candidates, single_sided=dcfg.single_sided_lights,
              has_met=dcfg.scene_has_metallic)
    k10 = ris_cdf.ris_cdf_cuda(pack, 1, t, scene.bvh, **kw)
    kc10, c10 = ris_cdf.ris_cdf_cuda(pack, 1, t, scene.bvh, stats=True,
                                     **kw)
    r10 = ris_cdf.ris_cdf_ref(pack, 1, t, **kw)
    torch.cuda.synchronize()
    if not bool(bits_equal(kc10, k10).all()):
        raise PhaseError("B10's counting build writes another pack")
    err10 = b10_twin_gate("B10 ris_cdf vs twin on the general G-buffer",
                          k10, r10, shade)
    ms = cuda_ms(lambda: ris_cdf.ris_cdf_cuda(pack, 1, t, scene.bvh, **kw),
                 10)
    ms_ref = cuda_ms(lambda: ris_cdf.ris_cdf_ref(pack, 1, t, **kw), 1)
    # the shadow walks this run makes: lanes with a live winner
    boxes, tests = walk_line("B10 shadow", c10, c10[0] > 0)
    n_l = t.n_lights
    b = ris_bound10(t, r, dcfg.cdf_candidates, boxes, tests, walk_tables)
    record["ris_cdf"] = dict(max_abs_err=err10, ms=ms, plain_ms=ms_ref,
                             bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"B10 ris_cdf: kernel {ms:.4f} ms, twin {ms_ref:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}; {n_l} lights, {boxes / r:.2f} box and "
          f"{tests / r:.2f} plane tests per pixel)")


def phase_general_main(name, scene, cfg, cam, dev, per_frame, warmup,
                       timed, with_scene=True):
    """A general main path through renderer.init_state / step; returns
    the launch counts of the run."""
    reset_counts()
    state = renderer.init_state(cfg, cam, scene if with_scene else None,
                                device=dev)
    if not isinstance(state, renderer.RenderState):
        raise PhaseError(f"{name}: init_state returned {type(state)}")
    frame = None
    for _ in range(warmup):
        state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(timed):
        state, frame = renderer.step(scene, state, cam, cfg)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    dev_ms = start.elapsed_time(end) / timed
    MAIN_WALL[name] = wall_ms
    counts = read_counts()
    expect = {k: per_frame.get(k, 0) * (warmup + timed) for k in counts}
    print(f"main path {name} launches {counts} (expected {expect})")
    if counts != expect:
        raise PhaseError(f"{name}: launch counts {counts} != {expect}")
    if tuple(frame.shape) != (cfg.num_pixels, 3):
        raise PhaseError(f"{name}: frame shape {tuple(frame.shape)}")
    if not bool(torch.isfinite(frame).all()):
        raise PhaseError(f"{name}: frame has non-finite values")
    mean = float(frame.mean())
    if not mean > 0.0:
        raise PhaseError(f"{name}: frame is black (mean {mean})")
    img = renderer.frame_to_image(frame, cfg)
    if img.dtype != torch.uint8 or tuple(img.shape) != (cfg.height,
                                                        cfg.width, 3):
        raise PhaseError(f"{name}: image {img.dtype} {tuple(img.shape)}")
    print(f"main path {name} {cfg.width}x{cfg.height}: {wall_ms:.3f} "
          f"ms/frame wall, {dev_ms:.3f} ms/frame device, "
          f"{1e3 / wall_ms:.3f} fps; frame mean {mean:.5f}, image mean "
          f"{float(img.float().mean()):.2f}")
    return counts


def phase_quality_gate(dev, arrays=None, camkw=None):
    """bench.py:49-80: fused spatiotemporal frames against the unbiased
    PT-direct reference on many_light_scene(36, 10) (or the scene given)
    at 384x384."""
    if arrays is None:
        arrays, camkw = many_light_scene(36, 10)
    scene = convert.scene_from_numpy(arrays, dev)
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=384, height=384, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE)
    t0 = time.perf_counter()
    state = renderer.init_state(cfg, cam, scene, device=dev)
    if not isinstance(state, renderer.FusedDIState):
        raise PhaseError("quality gate: the 384x384 DI frame is not fused")
    for _ in range(64):
        state, frame = renderer.step(scene, state, cam, cfg)
    got = frame.T.double()
    ref_cfg = cfg.replace(tracer=TracerType.PT_DIRECT)
    ref_state = renderer.init_state(ref_cfg, cam, scene, device=dev)
    for _ in range(256):
        ref_state, ref = renderer.step(scene, ref_state, cam, ref_cfg)
    ref = ref.double()
    torch.cuda.synchronize()
    ratio = float(got.mean() / max(float(ref.mean()), 1e-9))
    rel_rmse = float(torch.sqrt(((got - ref) ** 2).mean())
                     / max(float(ref.mean()), 1e-9))
    print(f"quality gate (384x384, {scene.tables.n_lights} light rows, 64 "
          f"fused RESTIR_DI vs 256 PT_DIRECT frames, "
          f"{time.perf_counter() - t0:.1f} s): energy_ratio_vs_pt "
          f"{ratio:.4f}, rel_rmse_vs_pt_64f {rel_rmse:.4f}")
    if not abs(ratio - 1.0) < 0.05:
        raise PhaseError(f"quality gate: energy ratio {ratio:.4f} is not "
                         "within 5 % of PT-direct")


def phase_general(scene, cam, arrays, dev, record, launches):
    """Phases 12-14: the general kernels, main paths and quality gate."""
    flags = mat_flags(arrays)
    phase_general_kernels(scene, cam, dev, record, launches, flags)
    base = RenderConfig(width=WIDTH, height=HEIGHT, **flags)
    total = {"primary_hit": 0, "any_hit": 0, "ris_cdf": 0}
    runs = [
        ("PT_DIRECT", base.replace(tracer=TracerType.PT_DIRECT),
         {"primary_hit": 2, "any_hit": 1}, WARMUP, TIMED, True),
        ("PT_FULL", base.replace(tracer=TracerType.PT_FULL, trace_depth=5),
         {"primary_hit": 7, "any_hit": 5}, GENERAL_WARMUP, GENERAL_TIMED,
         True),
        ("general DI cdf", base.replace(tracer=TracerType.RESTIR_DI,
                                        denoiser=DenoiserType.NONE),
         {"primary_hit": 1, "ris_cdf": 1, "ris_search": 1},
         GENERAL_WARMUP, GENERAL_TIMED, False),
        ("general DI reference",
         base.replace(tracer=TracerType.RESTIR_DI, ris_mode="reference",
                      denoiser=DenoiserType.NONE),
         {"primary_hit": 1, "any_hit": 1}, GENERAL_WARMUP, GENERAL_TIMED,
         False),
    ]
    for name, cfg, per_frame, warm, timed, with_scene in runs:
        counts = phase_general_main(name, scene, cfg, cam, dev, per_frame,
                                    warm, timed, with_scene)
        for k in total:
            total[k] += counts[k]
        profile_frames(name, scene, cfg, cam, dev, with_scene=with_scene)
    launches.update(total)
    phase_quality_gate(dev)


def max_err(a, b) -> float:
    """Largest |a - b| where a and b differ (NaN in both is agreement; a
    NaN or inf against a number reads 3.4e38)."""
    d = (a - b).abs()
    d = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0, d)
    return float(torch.nan_to_num(d, nan=3.4e38, posinf=3.4e38).max())


def lanes(a, b, rtol, atol, mask=None):
    """Share of lanes of [C, R] tensors whose every channel agrees."""
    ok = torch.isclose(a, b, rtol=rtol, atol=atol).all(0)
    return float((ok if mask is None else ok[mask]).float().mean())


def gi_trace_report(k, r, xv, depth):
    """B8's pack against its twin's under the JAX GI tests' gates: those
    of test_gi_trace_matches_xla at depth > 1, of
    test_gi_trace_depth1_exact (every lane) at depth 1."""
    _, _, kdelta, kvalid = restir_gi._sample_from_go(k, xv)
    _, _, rdelta, rvalid = restir_gi._sample_from_go(r, xv)
    lo, nv = slice(gi.GO_LO, gi.GO_LO + 3), slice(gi.GO_NV, gi.GO_NV + 3)
    xs, ns = slice(gi.GO_XS, gi.GO_XS + 3), slice(gi.GO_NS, gi.GO_NS + 3)
    pdf = slice(gi.GO_PDF, gi.GO_PDF + 1)
    same = (k == r) | (torch.isnan(k) & torch.isnan(r))
    st = {"exact_lanes": float(same.all(0).float().mean()),
          "exact_channels": float(same.all(1).float().mean()),
          "valid_eq": float((kvalid == rvalid).float().mean()),
          "delta_eq": float((kdelta == rdelta).float().mean()),
          "lo_mean": float(k[lo].mean()), "twin_lo_mean": float(r[lo].mean())}
    if depth > 1:
        st.update(lo=lanes(k[lo], r[lo], 2e-3, 2e-4),
                  pdf=lanes(k[pdf], r[pdf], 2e-3, 1e-5),
                  xs=lanes(k[xs], r[xs], 1e-3, 1e-4),
                  ns=lanes(k[ns], r[ns], 1e-3, 1e-4),
                  nv=lanes(k[nv], r[nv], 1e-4, 1e-5))
        ref = max(st["twin_lo_mean"], 1e-9)
        fails = [f"{n} {st[n]:.6f} <= {g}" for n, g in (
            ("lo", 0.97), ("pdf", 0.995), ("delta_eq", 0.995),
            ("valid_eq", 0.985), ("xs", 0.99), ("ns", 0.99), ("nv", 0.999))
            if not st[n] > g]
        if abs(st["lo_mean"] - ref) / ref >= 0.03:
            fails.append("mean Lo off by 3 % or more")
    else:
        st.update(lo=lanes(k[lo], r[lo], 1e-4, 1e-6),
                  pdf=lanes(k[pdf], r[pdf], 1e-3, 1e-6),
                  nv=lanes(k[nv], r[nv], 1e-4, 1e-6),
                  xs=lanes(k[xs], r[xs], 1e-3, 1e-4, rvalid),
                  ns=lanes(k[ns], r[ns], 1e-5, 1e-6, rvalid))
        fails = [f"{n} {st[n]:.6f} < 1" for n in (
            "valid_eq", "delta_eq", "lo", "pdf", "nv", "xs", "ns")
            if st[n] < 1.0]
    if st["exact_lanes"] < 1.0:  # the walks return the twin's every-row hits
        fails.append(f"exact lanes {st['exact_lanes']:.7f} < 1")
    return fails, st


def phase_gi_kernels(scene, cfg, cam, dev, record):
    """B8 and B9 against their twins at 1080p on B1's own G-buffer."""
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    t = scene.tables
    cv = pack_camera(cam, dev)
    kw1 = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
               has_met=cfg.scene_has_metallic)
    gb, _ = fused_di.di_resident_cuda(cv, cv, 1, torch.zeros(
        (PT_CH, r), device=dev), t, scene.bvh, **kw1)
    in_pack, gq = restir_di_fused.gi_packs(scene, gb)
    xv = in_pack[gi.IN_POS:gi.IN_POS + 3].T
    kw = restir_gi.trace_kwargs(scene, cfg)
    k8 = gi.gi_trace_cuda(in_pack, 1, scene, **kw)
    r8 = gi.gi_trace_ref(in_pack, 1, scene, **kw)
    torch.cuda.synchronize()
    fails, st = gi_trace_report(k8, r8, xv, kw["depth"])
    print(f"B8 gi_trace vs twin at {w}x{h}, depth {kw['depth']}, on B1's "
          f"G-buffer: {json.dumps(st)}")
    gate(fails, "B8 disagrees with its twin")
    kw_d1 = {**kw, "depth": 1}
    fails, st1 = gi_trace_report(gi.gi_trace_cuda(in_pack, 1, scene, **kw_d1),
                                 gi.gi_trace_ref(in_pack, 1, scene, **kw_d1),
                                 xv, 1)
    print(f"B8 gi_trace vs twin at depth 1 (every lane): {json.dumps(st1)}")
    gate(fails, "B8 disagrees with its twin at depth 1")
    ms = cuda_ms(lambda: gi.gi_trace_cuda(in_pack, 1, scene, **kw), 10)
    ms_ref = cuda_ms(lambda: gi.gi_trace_ref(in_pack, 1, scene, **kw), 1)
    _, counts = gi.gi_trace_cuda(in_pack, 1, scene, stats=True, **kw)
    boxes, tests, verts = (int(c) for c in counts.to(torch.int64).sum(1))
    n_tris = scene.num_tris
    b = bound(r * (gi.IN_CH + gi.GO_CH) * 4 + table_bytes(
        t.planes[:n_tris], t.gi_tri, t.mat, t.gi_lights, scene.bvh.rows),
        boxes * FLOP_BOX + tests * FLOP_PLANE + verts * FLOP_GI_VERTEX)
    record["gi_trace"] = dict(max_abs_err=max_err(k8, r8), ms=ms,
                              plain_ms=ms_ref, bound_ms=b[0], bound_by=b[1],
                              library_ms=None)
    # a warp (32 neighbouring pixels) runs as long as its longest path
    warp = counts.to(torch.float64).reshape(3, -1, 32)
    v_max = float(warp[2].amax(1).mean())
    b_max = float(warp[0].amax(1).mean())
    print(f"B8 walks at {w}x{h}: {boxes / r:.2f} box tests, {tests / r:.2f} "
          f"plane tests and {verts / r:.4f} path vertices per pixel "
          f"({boxes / max(tests, 1):.2f} boxes per plane test); per warp: "
          f"mean of the max vertices {v_max:.4f} ({v_max / (verts / r):.3f}x"
          f" the mean), mean of the max box tests {b_max:.2f} "
          f"({b_max / (boxes / r):.3f}x the mean)")
    print(f"B8 gi_trace: kernel {ms:.4f} ms, twin {ms_ref:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]})")

    # B9 over three frames of B1 + B8, the camera still
    q = torch.zeros((gi.Q_CH, r), device=dev)
    pt = torch.zeros((PT_CH, r), device=dev)
    worst = [1.0, 1.0, 1.0]
    err9 = 0.0
    for f in range(3):
        gb, pt = fused_di.di_resident_cuda(cv, cv, f, pt, t, scene.bvh,
                                           **kw1)
        in_pack, gq = restir_di_fused.gi_packs(scene, gb)
        go = gi.gi_trace_cuda(in_pack, f, scene, **kw)
        ind_k, q_k = gi.gi_resolve_cuda(go, in_pack, gq, q, f)
        ind_r, q_r = gi.gi_resolve_ref(go, in_pack, gq, q, f)
        torch.cuda.synchronize()
        m_eq = float((q_k[gi.Q_M] == q_r[gi.Q_M]).float().mean())
        w_ok = lanes(q_k[gi.Q_W:gi.Q_W + 1], q_r[gi.Q_W:gi.Q_W + 1], 1e-5,
                     1e-7)
        i_ok = lanes(ind_k, ind_r, 1e-3, 1e-6)
        worst = [min(a, b) for a, b in zip(worst, (m_eq, w_ok, i_ok))]
        err9 = max(err9, max_err(q_k, q_r), max_err(ind_k, ind_r))
        print(f"B9 gi_resolve vs twin, frame {f}: M equal {m_eq:.6f}, W "
              f"within rtol 1e-5 {w_ok:.6f}, indirect within rtol 1e-3 "
              f"{i_ok:.6f}, exact lanes "
              f"{float((q_k == q_r).all(0).float().mean()):.6f}, max M "
              f"{float(q_k[gi.Q_M].max()):.0f}")
        q = q_k
    if min(worst) < 0.9999:
        raise PhaseError("B9 disagrees with its twin")
    ms9 = cuda_ms(lambda: gi.gi_resolve_cuda(go, in_pack, gq, q, 2), 20)
    ms9_ref = cuda_ms(lambda: gi.gi_resolve_ref(go, in_pack, gq, q, 2), 2)
    # GO 14, IN 10, GQ 10 and the previous pack's 22 channels read; the
    # next pack's 24 and the indirect's 3 written
    b9 = bound(r * (14 + 10 + 10 + 22 + 24 + 3) * 4, r * FLOP_GI_RESOLVE)
    record["gi_resolve"] = dict(max_abs_err=err9, ms=ms9, plain_ms=ms9_ref,
                                bound_ms=b9[0], bound_by=b9[1],
                                library_ms=None)
    print(f"B9 gi_resolve: kernel {ms9:.4f} ms, twin {ms9_ref:.4f} ms, "
          f"bound {b9[0]:.4f} ms ({b9[1]})")


def phase_gi_main(name, scene, cfg, cam, dev):
    """A fused GI main path, its peak memory and its profile."""
    torch.cuda.reset_peak_memory_stats()
    counts = phase_main(name, scene, cfg, cam, dev, {
        "fused_di": 2, "spatial": 1, "gi_trace": 1, "gi_resolve": 1})
    print(f"main path {name}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_frames(name, scene, cfg, cam, dev)
    return counts


def phase_gi_agreement(scene, arrays, cam, dev):
    """The fused GI frame's mean indirect against the general GI step's
    (test_gi_fused_pipeline_step's 5 % gate) at 384x384, 8 frames."""
    cfg = RenderConfig(width=384, height=384, tracer=TracerType.RESTIR_GI,
                       **mat_flags(arrays))
    means = {}
    for kind, with_scene in (("fused", True), ("general", False)):
        state = renderer.init_state(cfg, cam, scene if with_scene else None,
                                    device=dev)
        for _ in range(8):
            state, _ = renderer.step(scene, state, cam, cfg)
        ind = (state.accum_ind if isinstance(state, renderer.FusedDIState)
               else state.indirect_illum)
        means[kind] = float(ind.double().mean())
    ratio = means["fused"] / max(means["general"], 1e-12)
    print(f"GI agreement (384x384, 8 frames): mean indirect fused "
          f"{means['fused']:.6f}, general {means['general']:.6f}, ratio "
          f"{ratio:.4f}")
    if not abs(ratio - 1.0) < 0.05:
        raise PhaseError(f"fused and general GI differ: ratio {ratio:.4f}")


def phase_gi_fallback(dev):
    """RESTIR_GI with an env map falls off the fused path: one notice,
    naming the GI gate, then a general frame."""
    arrays, camkw = env_scene()
    scene = convert.scene_from_numpy(arrays, dev)
    cam = make_camera(**camkw)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                       tracer=TracerType.RESTIR_GI, has_env_map=True,
                       **mat_flags(arrays))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = renderer.init_state(cfg, cam, scene, device=dev)
        renderer.init_state(cfg, cam, scene, device=dev)
    notes = [str(w.message) for w in caught]
    print(f"fallback notice (env_scene, has_env_map): {notes}")
    if (len(notes) != 1 or "gi_resolve_fused_eligible" not in notes[0]
            or "has_env_map" not in notes[0]):
        raise PhaseError("RESTIR_GI with an env map did not warn once, "
                         "naming the GI gate")
    if not isinstance(state, renderer.RenderState) or not isinstance(
            state.gi_reservoir, rsv.Reservoir):
        raise PhaseError("RESTIR_GI with an env map is not the general state")
    reset_counts()
    t0 = time.perf_counter()
    state, frame = renderer.step(scene, state, cam, cfg)
    torch.cuda.synchronize()
    print(f"general GI frame with the env map: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first frame), "
          f"launches {read_counts()}, mean {float(frame.mean()):.5f}")
    if not bool(torch.isfinite(frame).all()) or not float(frame.mean()) > 0:
        raise PhaseError("the env-lit general GI frame is not finite and lit")


def phase_gi(scene, arrays, cam, dev, record, launches):
    """Phases 15-18: ReSTIR GI."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                       tracer=TracerType.RESTIR_GI, **mat_flags(arrays))
    phase_gi_kernels(scene, cfg, cam, dev, record)
    counts = phase_gi_main("GI headline", scene, cfg, cam, dev)
    cb_arrays, cb_kw = cornell_box()
    cb_scene = convert.scene_from_numpy(cb_arrays, dev)
    cb_cfg = RenderConfig(width=WIDTH, height=HEIGHT,
                          tracer=TracerType.RESTIR_GI, **mat_flags(cb_arrays))
    cb_counts = phase_gi_main("GI cornell", cb_scene, cb_cfg,
                              make_camera(**cb_kw), dev)
    torch.cuda.reset_peak_memory_stats()
    g_counts = phase_general_main(
        "general GI", scene, cfg, cam, dev,
        {"primary_hit": 1, "ris_cdf": 1, "ris_search": 1, "gi_trace": 1},
        GENERAL_WARMUP,
        GENERAL_TIMED, with_scene=False)
    print(f"main path general GI: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_frames("general GI", scene, cfg, cam, dev, with_scene=False)
    launches["gi_trace"] = (counts["gi_trace"] + cb_counts["gi_trace"]
                            + g_counts["gi_trace"])
    launches["gi_resolve"] = counts["gi_resolve"] + cb_counts["gi_resolve"]
    phase_gi_agreement(scene, arrays, cam, dev)
    phase_gi_fallback(dev)


def exactness(what, same_prim, lanes_eq, close):
    """Print and gate a walk kernel against its twin: bit for bit on every
    lane, else the reference's gates (primitive mismatch <= 0.2 %,
    matched lanes within rtol 2e-4) with the lanes that differ."""
    exact = float(lanes_eq.float().mean())
    sp = float(same_prim.float().mean())
    print(f"{what}: exact lanes {exact:.7f}, primitive match {sp:.7f}, "
          f"matched lanes within rtol 2e-4 {close:.7f}")
    if bool(lanes_eq.all()):
        return
    print(f"{what}: NOT bit for bit its twin on "
          f"{int((~lanes_eq).sum())} lanes; the reference's gates apply")
    if sp < 0.998 or close < 0.999:
        raise PhaseError(f"{what} disagrees with its twin")


def b13_launches(what, fn, ref):
    """Phase 19: a B13 or B14 entry point `fn(geom)` in both launches: in
    ray
    order (the first design's, which a batch without geometry keeps) and
    on the 8x4-pixel warps of the whole frame's geometry; each must write
    `ref`'s bits. Prints the mean ms of 20 launches of each and returns
    the tiled launch's."""
    ms = {}
    for launch, geom in (("ray order", None), ("8x4 tiles", (WIDTH, 0))):
        if not bool(bits_equal(fn(geom), ref).all()):
            raise PhaseError(f"{what}: the launch in {launch} does not "
                             "write the twin's bits")
        ms[launch] = cuda_ms(lambda: fn(geom), 20)
    print(f"{what}: kernel ms by launch "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms["8x4 tiles"]


def phase_walk_kernels(hall, cam, dev, record):
    """Phase 19: B13 (closest, any and primary hit) and B14 against their
    twins at 1080p on the hall, every lane: the hall's own camera rays,
    PT-full's first bounce rays from their hits and NEE segments
    (`kernel_ab.general_rays`; "auto" takes the walk on 81,036
    triangles)."""
    r = WIDTH * HEIGHT
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        g = general_rays(hall, cam, dev)
    trv = g["trv"]
    if trv.method != "bvh" or trv.walk is None:
        raise PhaseError(f"the hall's intersector is {trv.method!r}")
    w = trv.walk
    n = hall.num_tris
    tables = table_bytes(w.rows, w.vert_rows[:n])
    attr, mats = hall.prim_attr, hall.mat_attr
    print(f"B13 / B14 on the hall: rays and the twin's camera hits in "
          f"{time.perf_counter() - t0:.1f} s; walk tables "
          f"{table_bytes(w.rows) / 2**20:.1f} MiB node rows + "
          f"{table_bytes(w.vert_rows) / 2**20:.1f} MiB vertex rows")
    for kernel in ("mt_closest_kernel", "mt_any_kernel", "primary_kernel",
                   "heatmap_kernel"):
        print(f"ptxas intersect.cu {kernel}: "
              f"{ptxas_report('intersect.cu', kernel)}")
    frame = (WIDTH, 0)  # every ray batch below is one ray per pixel

    def twin_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # primary hit on the camera rays: every lane of the pack
    o, d = g["o"], g["d"]
    k = hits.mt_primary_cuda(trv, attr, mats, o, d, geom=frame)
    kc, c_prim = hits.mt_primary_cuda(trv, attr, mats, o, d, stats=True,
                                      geom=frame)
    ref, ms_ref = twin_ms(lambda: hits.primary_ref(trv, attr, mats, o, d))
    same = k[hits.CH_PRIM] == ref[hits.CH_PRIM]
    hit = same & (ref[hits.CH_PRIM] >= 0)
    close = float(torch.isclose(k[:, hit], ref[:, hit], rtol=2e-4,
                                atol=1e-6).all(0).float().mean())
    exactness("B13 primary hit on the hall's camera rays", same,
              bits_equal(k, ref).all(0), close)
    if not torch.equal(kc, k):
        raise PhaseError("B13 primary: the counting build writes another "
                         "pack")
    boxes, tests = walk_line("B13 primary camera-ray", c_prim)
    walk_spread("B13 primary camera rays", c_prim)
    ms = b13_launches("B13 primary hit on the hall's camera rays",
                      lambda geom: hits.mt_primary_cuda(
                          trv, attr, mats, o, d, geom=geom), ref)
    b = bound(r * (24 + hits.PRIMARY_CH * 4) + tables
              + table_bytes(attr, mats),
              boxes * FLOP_BOX + tests * FLOP_MT + r * FLOP_B12_EPI)
    record["mt_primary"] = dict(max_abs_err=max_err(k, ref), ms=ms,
                                plain_ms=ms_ref, bound_ms=b[0], bound_by=b[1],
                                library_ms=None)
    print(f"B13 primary hit: kernel {ms:.4f} ms, twin {ms_ref:.1f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]}), {n} triangles")
    ro, rd, live = g["ro"], g["rd"], g["bounce_live"]
    kb = hits.mt_primary_cuda(trv, attr, mats, ro, rd, live, geom=frame)
    rb = hits.primary_ref(trv, attr, mats, ro, rd, live)
    same = kb[hits.CH_PRIM] == rb[hits.CH_PRIM]
    hit = same & (rb[hits.CH_PRIM] >= 0)
    close = float(torch.isclose(kb[:, hit], rb[:, hit], rtol=2e-4,
                                atol=1e-6).all(0).float().mean())
    exactness("B13 primary hit on the first bounce rays (live lanes)", same,
              bits_equal(kb, rb).all(0), close)
    walk_spread("B13 primary first-bounce rays",
                hits.mt_primary_cuda(trv, attr, mats, ro, rd, live,
                                     stats=True, geom=frame)[1], live)
    b13_launches("B13 primary hit on the first bounce rays (live lanes)",
                 lambda geom: hits.mt_primary_cuda(
                     trv, attr, mats, ro, rd, live, geom=geom), rb)

    # closest hit on the bounce rays, every lane: the ray key, the radix
    # sort and the walk through the permutation
    pk, dk, bk = hits.mt_closest_cuda(trv, ro, rd)
    _, _, _, c_cl = hits.mt_closest_cuda(trv, ro, rd, stats=True)
    (pr, dr, br), ms_ref = twin_ms(
        lambda: intersect.intersect_closest_bvh(w, ro, rd))
    both = (pk == pr) & (pr >= 0)
    close = float((torch.isclose(dk[both], dr[both], rtol=2e-4)
                   & torch.isclose(bk[both], br[both], rtol=2e-4,
                                   atol=1e-5).all(1)).float().mean())
    exactness("B13 closest hit on the first bounce rays", pk == pr,
              bits_equal(pk, pr) & bits_equal(dk, dr)
              & bits_equal(bk, br).all(1), close)
    # its walk counts against the primary hit's counting build, whose walk
    # (exact_closest_walk, the slab test in ray order) is unchanged
    _, c_pb = hits.mt_primary_cuda(trv, attr, mats, ro, rd, stats=True)
    if not torch.equal(c_cl, c_pb):
        raise PhaseError(
            "B13 closest hit: box / triangle tests differ from the primary "
            f"hit's counting build on {int((c_cl != c_pb).any(0).sum())} rays")
    print("B13 closest hit: box and triangle tests per ray equal the "
          "primary hit's counting build on every lane")
    boxes, tests = walk_line("B13 closest-hit", c_cl)
    ms = cuda_ms(lambda: hits.mt_closest_cuda(trv, ro, rd), 10)
    b = bound(r * (24 + 16) + tables, boxes * FLOP_BOX + tests * FLOP_MT)
    err = float((dk[both] - dr[both]).abs().max()) if bool(both.any()) \
        else 0.0
    record["mt_closest"] = dict(max_abs_err=err, ms=ms, plain_ms=ms_ref,
                                bound_ms=b[0], bound_by=b[1],
                                library_ms=None)
    print(f"B13 closest hit: kernel {ms:.4f} ms (key, sort and walk), twin "
          f"{ms_ref:.1f} ms, bound {b[0]:.4f} ms ({b[1]})")
    # its pieces: the key and the sort against their twins, bit for bit
    key = ray_order.ray_key(ro, rd, None, w.rows)
    passes = ray_order.RAY_SORT_PASSES
    vals, perm = ray_order.radix_sort(key, passes)
    vr, pr_ = ray_order.radix_sort_ref(key)
    if not (torch.equal(key, ray_order.ray_key_ref(ro, rd, None, w.rows))
            and torch.equal(vals, vr) and torch.equal(perm, pr_)):
        raise PhaseError("B13 closest hit: the ray key or its sort differs "
                         "from its twin")
    t = probe_ms({"key": lambda: ray_order.ray_key(ro, rd, None, w.rows),
        "key_ref": lambda: ray_order.ray_key_ref(ro, rd, None, w.rows),
        "sort": lambda: ray_order.radix_sort(key, passes),
        "sort_ref": lambda: ray_order.radix_sort_ref(key),
        "walk": lambda: hits.mt_closest_walk(trv, ro, rd, None, perm),
        "torch.sort": lambda: torch.sort(key, stable=True)})
    # the key reads o, d (24 B a ray) and the root row (32 B), and writes
    # the key (4 B); active is None here
    record["ray_key"] = probe_record(t["key"][0], t["key_ref"][0],
                                     28 * r + 32, FLOP_RAY_KEY * r, None,
                                     0.0)
    record["ray_sort"] = probe_record(t["sort"][0], t["sort_ref"][0], 12 * r,
                                      0.0, t["torch.sort"][0], 0.0)
    print(f"B13 closest hit pieces, device ms (events): key "
          f"{t['key'][0]:.4f} ({t['key'][1]:.4f}), sort {t['sort'][0]:.4f} "
          f"({t['sort'][1]:.4f}), walk {t['walk'][0]:.4f} "
          f"({t['walk'][1]:.4f}); torch.sort {t['torch.sort'][0]:.4f}; the "
          f"key and sort equal their twins")
    # the warps as the walk launches them: 32 consecutive sorted slots
    walk_line("B13 closest-hit, sorted order", c_cl[:, perm.long()])
    walk_sass_report("B13 closest", "mt_closest_kernel", boxes,
                     lambda: hits.mt_closest_walk(trv, ro, rd, None, perm))

    # any hit on NEE segments from the camera hits
    pos, target, shoot = g["pos"], g["target"], g["shoot"]
    occ = hits.mt_any_cuda(trv, pos, target, shoot, geom=frame)
    occ_c, c_any = hits.mt_any_cuda(trv, pos, target, shoot, stats=True,
                                    geom=frame)
    occ_r, ms_ref = twin_ms(
        lambda: intersect.test_occlusion_bvh(w, pos, target, shoot))
    eq = occ == occ_r
    print(f"B13 any hit on {int(shoot.sum())} NEE segments: equal on "
          f"{float(eq.float().mean()):.7f} of lanes, occluded "
          f"{float(occ[shoot].float().mean()):.4f}")
    if float(eq[shoot].float().mean()) < 0.998 or not torch.equal(occ_c,
                                                                   occ):
        raise PhaseError("B13's any hit disagrees with its twin")
    if not bool(eq.all()):
        print("B13 any hit: NOT its twin's on every lane; the reference's "
              "gates apply")
    boxes, tests = walk_line("B13 any-hit", c_any, shoot)
    walk_spread("B13 any hit NEE segments", c_any, shoot)
    ms = b13_launches("B13 any hit on the NEE segments",
                      lambda geom: hits.mt_any_cuda(
                          trv, pos, target, shoot, geom=geom), occ)
    b = bound(r * (24 + 2) + tables,
              boxes * FLOP_BOX + tests * FLOP_MT
              + int(shoot.sum()) * FLOP_SEGMENT)
    record["mt_any"] = dict(max_abs_err=float((~eq).any()), ms=ms,
                            plain_ms=ms_ref, bound_ms=b[0], bound_by=b[1],
                            library_ms=None)
    print(f"B13 any hit: kernel {ms:.4f} ms, twin {ms_ref:.1f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]})")

    # B14 on the pixel-centre camera rays the heatmap casts
    x, y = pixel_centers(WIDTH, HEIGHT, dev)
    ho, hd = sample_rays(cam, WIDTH, HEIGHT, x, y, torch.full_like(x, 0.5),
                         torch.full_like(y, 0.5))
    ho, hd = ho.contiguous(), hd.contiguous()
    cnt = hits.heatmap_cuda(trv, ho, hd, geom=frame)
    cnt_c, c_heat = hits.heatmap_cuda(trv, ho, hd, stats=True, geom=frame)
    cnt_r, ms_ref = twin_ms(lambda: intersect.intersect_visualize(w, ho, hd))
    eq = float((cnt == cnt_r).float().mean())
    c = cnt.to(torch.float64)
    print(f"B14 heatmap vs twin: counts equal on {eq:.7f} of pixels; "
          f"descended nodes per ray mean {float(c.mean()):.2f}, max "
          f"{int(cnt.max())}")
    if eq < 0.999 or not torch.equal(cnt_c, cnt):
        raise PhaseError("B14 disagrees with its twin")
    if eq < 1.0:
        print("B14: NOT its twin's count on every pixel; the reference's "
              "gate (>= 99.9 %) applies")
    boxes, tests = walk_line("B14 heatmap", c_heat)
    walk_spread("B14 heatmap camera rays", c_heat)
    ms = b13_launches("B14 on the hall's pixel-centre rays",
                      lambda geom: hits.heatmap_cuda(trv, ho, hd, geom=geom),
                      cnt)
    walk_sass_report("B14", "heatmap_kernel", boxes,
                      lambda: hits.heatmap_cuda(trv, ho, hd, geom=frame))
    b = bound(r * (24 + 4) + tables, boxes * FLOP_BOX + tests * FLOP_MT)
    record["heatmap"] = dict(max_abs_err=float((cnt - cnt_r).abs().max()),
                             ms=ms, plain_ms=ms_ref, bound_ms=b[0],
                             bound_by=b[1], library_ms=None)
    print(f"B14 heatmap: kernel {ms:.4f} ms, twin {ms_ref:.1f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]})")
    return trv, ro, rd


def mean_image(scene, cfg, cam, frames, dev, with_scene=True):
    """The running mean of `frames` frames of cfg from a fresh state, as
    float64 [R, 3] (a fused frame [3, R] is transposed and copied: the
    next step would update it in place)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # auto's notice: the walk
        state = renderer.init_state(cfg, cam,
                                    scene if with_scene else None,
                                    device=dev)
        for _ in range(frames):
            state, frame = renderer.step(scene, state, cam, cfg)
    if isinstance(state, renderer.FusedDIState):
        frame = frame.T
    return frame.double().clone()


def material_split(scene, cfg, cam, images):
    """{image name: {material type: its pixels' share of the frame mean}}
    by the material of each pixel-centre primary hit (-1: lights and
    misses)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gb, it, mat, _ = general_gb.render_gbuffer(
            scene, cam, cam, cfg.replace(aa_jitter=False), 0)
    typ = torch.where(it.valid & (gb.prim_id >= 0), mat.type.long(), -1)
    out = {}
    for name, img in images.items():
        lum = img.mean(dim=1)
        out[name] = {int(t): round(float(lum[typ == t].sum() / lum.numel()),
                                   6) for t in typ.unique()}
    return out


def phase_hall_energy(hall, hall_arrays, cam, dev):
    """Phase 22: the hall's fused RESTIR_DI (64 frames) against its
    PT_DIRECT (256 frames, the MTBVH walk) at 384x384, in each of the
    four reuse modes; two more estimators of the same direct light (the
    general ReSTIR DI step in reference mode, 32 power-proportional
    candidates and a shadow ray, reuse NONE, 64 frames; PT_FULL at depth
    1, 256 frames); the reference through brute force (B11 / B12); and
    the light by material. A measurement, not a gate (ROADMAP Queue
    C)."""
    cfg = RenderConfig(width=384, height=384, tracer=TracerType.RESTIR_DI,
                       denoiser=DenoiserType.NONE, **mat_flags(hall_arrays))
    t0 = time.perf_counter()
    if not isinstance(renderer.init_state(cfg, cam, hall, device=dev),
                      renderer.FusedDIState):
        raise PhaseError("hall energy: the 384x384 DI frame is not fused")
    ref_cfg = cfg.replace(tracer=TracerType.PT_DIRECT)
    ref = mean_image(hall, ref_cfg, cam, 256, dev)
    modes = {"NONE": ReuseMode.NONE, "TEMPORAL": ReuseMode.TEMPORAL,
             "SPATIAL": ReuseMode.SPATIAL,
             "SPATIOTEMPORAL": ReuseMode.SPATIOTEMPORAL}
    fused = {name: mean_image(hall, cfg.replace(reuse=m), cam, 64, dev)
             for name, m in modes.items()}
    got = fused["SPATIOTEMPORAL"]
    general_ref = mean_image(hall, cfg.replace(
        ris_mode="reference", reuse=ReuseMode.NONE), cam, 64, dev,
        with_scene=False)
    pt_full1 = mean_image(hall, cfg.replace(tracer=TracerType.PT_FULL,
                                            trace_depth=1), cam, 256, dev)
    # the same reference through B11 / B12: brute force's plane test on
    # its padded MTBVH walk, at any size
    brute_cfg = ref_cfg.replace(intersector="brute")
    reset_counts()
    ref_b = mean_image(hall, brute_cfg, cam, 256, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["primary_hit"] < 512 or counts["any_hit"] < 256 or (
            counts["mt_primary"] + counts["mt_any"]):
        raise PhaseError(f"hall energy: the brute reference launched "
                         f"{counts}")
    images = {"PT-direct": ref, "PT-direct brute": ref_b,
              "general DI reference": general_ref, "PT-full depth 1":
              pt_full1, **{f"fused {k}": v for k, v in fused.items()}}
    if not all(bool(torch.isfinite(v).all()) for v in images.values()):
        raise PhaseError("hall energy: non-finite frames")
    mean = {k: float(v.mean()) for k, v in images.items()}
    ratio = mean["fused SPATIOTEMPORAL"] / max(mean["PT-direct"], 1e-9)
    ratio_b = mean["fused SPATIOTEMPORAL"] / max(mean["PT-direct brute"],
                                                  1e-9)
    rel_rmse = float(torch.sqrt(((got - ref) ** 2).mean())
                     / max(mean["PT-direct"], 1e-9))
    print(f"hall energy (384x384, 64 fused RESTIR_DI vs 256 PT_DIRECT "
          f"frames each way, {time.perf_counter() - t0:.1f} s): fused mean "
          f"{mean['fused SPATIOTEMPORAL']:.6f}, PT-direct mean "
          f"{mean['PT-direct']:.6f} (the walk, B13), "
          f"{mean['PT-direct brute']:.6f} (brute, B11 / B12); brute / walk "
          f"reference {mean['PT-direct brute'] / mean['PT-direct']:.4f}")
    print(f"energy_ratio_vs_pt {ratio:.4f} (hall; rel_rmse_vs_pt_64f "
          f"{rel_rmse:.4f}; within 5 %: {abs(ratio - 1.0) < 0.05}); against "
          f"the brute reference {ratio_b:.4f}")
    print("hall energy by estimator (mean; ratio to PT-direct): " + "; ".join(
        f"{k} {v:.6f} ({v / mean['PT-direct']:.4f})" for k, v in mean.items()))
    print(f"hall energy by material (0 Lambertian, 1 metallic, 2 dielectric,"
          f" -1 lights and misses): "
          f"{json.dumps(material_split(hall, cfg, cam, images))}")


def phase_walk(scene, cam, arrays, hall, hall_arrays, hall_cam, dev, record,
               launches):
    """Phases 19-22: the MTBVH walk (B13), the BVH heatmap (B14), the
    general denoisers, the Sobol sampler and the hall's energy."""
    trv, ro, rd = phase_walk_kernels(hall, hall_cam, dev, record)
    phase_wall("19 walk kernels")
    # No render path casts closest-hit rays (bounces go through the
    # primary build), so B13's closest hit is driven through the ray
    # query entry point, as B11's is: one ray key, one sort (1 + passes
    # kernels by the sort's own count) and one walk.
    reset_counts()
    n0 = ray_order.sort_kernel_launches()
    hit = intersect.intersect_closest(trv, ro, rd)
    torch.cuda.synchronize()
    counts = read_counts()
    sort_kernels = ray_order.sort_kernel_launches() - n0
    passes = ray_order.RAY_SORT_PASSES
    print(f"main path ray query (intersect_closest on the hall's {ro.shape[0]} "
          f"bounce rays, the walk) launches {counts}; the sort's kernels "
          f"{sort_kernels}")
    want = {"mt_closest": 1, "ray_key": 1, "ray_sort": 1}
    if (counts != {k: want.get(k, 0) for k in counts}
            or sort_kernels != 1 + passes):
        raise PhaseError(f"walk ray query: launch counts {counts}, sort "
                         f"kernels {sort_kernels}")
    if not bool((hit.prim_id >= 0).any()):
        raise PhaseError("walk ray query: no hits")
    for k in want:
        launches[k] = counts[k]

    hall_flags = mat_flags(hall_arrays)
    base = RenderConfig(width=WIDTH, height=HEIGHT, **hall_flags)
    levels = base.eaw_levels
    runs = [
        ("hall PT-direct", hall, hall_cam,
         base.replace(tracer=TracerType.PT_DIRECT),
         {"mt_primary": 2, "mt_any": 1}),
        ("hall general DI + SVGF", hall, hall_cam,
         base.replace(tracer=TracerType.RESTIR_DI, intersector="bvh",
                      ris_mode="cdf", denoiser=DenoiserType.SVGF),
         {"mt_primary": 1, "ris_cdf": 1, "ris_search": 1,
          "svgf_variance": levels, "atrous_svgf": levels}),
        ("hall heatmap", hall, hall_cam,
         base.replace(tracer=TracerType.BVH_VISUALIZE),
         {"heatmap": 1, "mt_primary": 1}),
        ("headline PT-direct Sobol EAW", scene, cam,
         RenderConfig(width=WIDTH, height=HEIGHT, tracer=TracerType.PT_DIRECT,
                      sampler="sobol", denoiser=DenoiserType.EAW,
                      **mat_flags(arrays)),
         {"primary_hit": 2, "any_hit": 1, "atrous_eaw": levels}),
    ]
    for name, sc, c, cfg, per_frame in runs:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the walk / fallback notices
            counts = phase_general_main(name, sc, cfg, c, dev, per_frame,
                                        GENERAL_WARMUP, GENERAL_TIMED)
            profile_frames(name, sc, cfg, c, dev)
        for k in per_frame:
            launches[k] = launches.get(k, 0) + counts[k]
    phase_hall_energy(hall, hall_arrays, hall_cam, dev)

STATS_KEYS = {"fps", "mrays_per_s", "compile_s", "frames", "resolution",
              "output"}  # restir_tpu/app.py's stats line
CLI_SIZE = 800  # the CLI's width and height of a builtin scene


def run_cli(name, argv, dev, per_frame=None):
    """`app.main(argv)` in this process, its output printed; returns its
    stats line. With per_frame, the run's launch counts must be those per
    frame times --frames."""
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv + ["--stats-json"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(buf.getvalue(), end="")
    if rc != 0:
        raise PhaseError(f"{name}: app.main returned {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(stats) != STATS_KEYS:
        raise PhaseError(f"{name}: stats keys {sorted(stats)}")
    if per_frame is not None:
        expect = {k: per_frame.get(k, 0) * stats["frames"] for k in counts}
        print(f"CLI {name} launches {counts} (expected {expect})")
        if counts != expect:
            raise PhaseError(f"{name}: launch counts {counts} != {expect}")
    print(f"CLI {name}: {stats['fps']} fps, {stats['mrays_per_s']} Mrays/s, "
          f"compile_s {stats['compile_s']}, {wall:.2f} s in main")
    return stats


def check_image(name, path, shape):
    img = read_pfm(path) if path.endswith(".pfm") else read_png(path)
    if img.shape != shape or not np.isfinite(img).all():
        raise PhaseError(f"{name}: output {img.shape}, finite "
                         f"{bool(np.isfinite(img).all())}")
    if not img.mean() > 0:
        raise PhaseError(f"{name}: output is black")
    return img


def phase_cli(dev, tmp):
    """Phase 23: the CLI at full width, in this process and as a module."""
    hd = ["--builtin", "many_light", "--width", str(WIDTH), "--height",
          str(HEIGHT)]
    out = os.path.join(tmp, "headline.png")
    run_cli("headline EAW", hd + ["--denoiser", "eaw", "--frames", "40",
                                  "-o", out], dev,
            {"fused_di": 2, "spatial": 1, "atrous_eaw": 5})
    check_image("CLI headline", out, (HEIGHT, WIDTH, 3))
    out = os.path.join(tmp, "pt_direct.png")
    run_cli("headline PT-direct", hd + ["--tracer", "pt_direct", "--frames",
                                        "8", "-o", out], dev,
            {"primary_hit": 2, "any_hit": 1})
    check_image("CLI PT-direct", out, (HEIGHT, WIDTH, 3))

    lib = _build.build()  # the cached library: no nvcc here
    stamp = lib.stat().st_mtime_ns
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = os.path.join(tmp, "cornell.png")
    cmd = [sys.executable, "-m", "restir_tpu_torch", "--builtin", "cornell",
           "--frames", "4", "--stats-json", "-o", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise PhaseError(f"python -m restir_tpu_torch: rc {proc.returncode}"
                         f"\n{proc.stderr[-4000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    if set(stats) != STATS_KEYS:
        raise PhaseError(f"python -m restir_tpu_torch: keys {sorted(stats)}")
    check_image("CLI cornell (module)", out, (CLI_SIZE, CLI_SIZE, 3))
    if lib.stat().st_mtime_ns != stamp:
        raise PhaseError("python -m restir_tpu_torch rebuilt the kernels")
    print(f"CLI module run (python -m restir_tpu_torch --builtin cornell, "
          f"{CLI_SIZE}x{CLI_SIZE} general DI): {stats['fps']} fps, compile_s "
          f"{stats['compile_s']} (the cached kernel library "
          f"{lib.name}), {wall:.2f} s with the interpreter's start")


def phase_native_hall(dev, tmp):
    """Phase 24: the native builder on the hall, then the hall through
    the CLI with a checkpoint."""
    hall_txt = os.path.join(REPO, "scenes", "hall.txt")
    sf = parse_scene_file(hall_txt)
    setup = {}
    built = {}
    for impl in ("numpy", "native"):
        t0 = time.perf_counter()
        built[impl] = sf.build(bvh_impl=impl)
        convert.scene_from_numpy(built[impl], dev)
        torch.cuda.synchronize()
        setup[impl] = time.perf_counter() - t0
    verts = built["native"].verts.reshape(-1, 3)
    times, trees = {}, {}
    for impl in ("numpy", "native"):
        t0 = time.perf_counter()
        trees[impl] = scene_bvh.build_bvh(verts, impl=impl)
        times[impl] = time.perf_counter() - t0
    same = all(np.array_equal(getattr(trees["numpy"], f),
                              getattr(trees["native"], f))
               for f in trees["numpy"]._fields)
    same_scene = all(np.array_equal(getattr(built["numpy"], f),
                                    getattr(built["native"], f))
                     for f in ("bounds_lo", "bounds_hi", "bvh_prim",
                               "bvh_box", "bvh_miss"))
    print(f"native BVH on the hall ({verts.shape[0] // 3} triangles, "
          f"{trees['native'].size} nodes): numpy {times['numpy']:.3f} s, "
          f"native {times['native']:.3f} s; trees equal bit for bit: "
          f"{same} (scene arrays {same_scene}); hall set-up (parse + "
          f"build + upload) numpy {setup['numpy']:.3f} s, native "
          f"{setup['native']:.3f} s")
    if not (same and same_scene):
        raise PhaseError("native BVH differs from the numpy builder's")

    per_frame = {"gbuffer_bvh": 1, "reuse_bvh": 1, "ris_search": 1,
                 "temporal": 1, "spatial": 1}
    ck = os.path.join(tmp, "hall_state.npz")
    out = {k: os.path.join(tmp, f"hall_{k}.pfm")
           for k in ("first", "resumed", "straight")}
    for name, argv in (
            ("hall 10 frames, save", ["--frames", "10", "--save-state", ck,
                                      "-o", out["first"]]),
            ("hall resumed 4 frames", ["--frames", "4", "--load-state", ck,
                                       "-o", out["resumed"]]),
            ("hall 14 frames", ["--frames", "14", "-o", out["straight"]])):
        t0 = time.perf_counter()
        stats = run_cli(name, [hall_txt] + argv, dev, per_frame)
        print(f"CLI {name}: set-up + first frame + output "
              f"{time.perf_counter() - t0 - (stats['frames'] - 1) / stats['fps']:.3f} s "
              f"(compile_s {stats['compile_s']})")
    img = {k: check_image(f"CLI {k}", v, (HEIGHT, WIDTH, 3))
           for k, v in out.items()}
    ok = np.isclose(img["straight"], img["resumed"], rtol=1e-4,
                    atol=1e-6).all(-1).mean()
    exact = bool(np.array_equal(img["straight"], img["resumed"]))
    moved = not np.allclose(img["first"], img["resumed"])
    print(f"hall checkpoint: 10 + 4 resumed frames against 14 straight: "
          f"pixels within rtol 1e-4 {ok:.6f}, bit for bit {exact}; the "
          f"resumed image moved from the saved one: {moved}")
    if not (ok >= 0.995 and moved):
        raise PhaseError("hall checkpoint did not resume")


def phase_viewer(scene, arrays, cam, dev, tmp):
    """Phase 25: the browser viewer on the headline builtin at the CLI's
    800x800."""
    cfg = RenderConfig(width=CLI_SIZE, height=CLI_SIZE, **mat_flags(arrays))
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 800 px: the general DI notice
        server, state, render = viewer.make_server(scene, cfg, cam, port=0)
    host, port = server.server_address[:2]
    serving = threading.Thread(target=server.serve_forever)
    serving.start()

    def get(path):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def stats():
        return json.loads(get("/stats")[1])

    def wait(cond, what, timeout=300.0):
        deadline = time.time() + timeout
        while not cond():
            if state.error is not None or time.time() > deadline:
                raise PhaseError(f"viewer: no {what} ({state.error!r})")
            time.sleep(0.05)

    def rate(what, seconds=3.0):
        """Frames per second over a window without polls (the render
        thread shares the interpreter lock with the server's); /stats'
        fps is an average that starts at 0 and lags."""
        s0, t0 = stats(), time.perf_counter()
        time.sleep(seconds)
        s1, t1 = stats(), time.perf_counter()
        fps = (s1["iteration"] - s0["iteration"]) / (t1 - t0)
        print(f"viewer {what}: {fps:.2f} fps over {t1 - t0:.2f} s "
              f"(/stats fps {s1['fps']:.2f})")

    def frame():
        """The next PNG on /stream."""
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            conn.request("GET", "/stream")
            resp = conn.getresponse()  # closes its fp when collected
            fp = resp.fp
            while fp.readline().strip() != b"--frame":
                pass
            head = {}
            while line := fp.readline().strip():
                k, v = line.decode().split(":", 1)
                head[k.strip().lower()] = v.strip()
            body = fp.read(int(head["content-length"]))
        finally:
            conn.close()
        if head["content-type"] != "image/png" or not body.startswith(
                b"\x89PNG\r\n\x1a\n"):
            raise PhaseError(f"viewer: stream part {head}")
        return body

    try:
        t0 = time.perf_counter()
        wait(lambda: stats()["iteration"] >= 10, "10 frames")
        print(f"viewer: 10 frames after {time.perf_counter() - t0:.2f} s")
        rate(f"restir_di {CLI_SIZE}x{CLI_SIZE}")
        path = os.path.join(tmp, "viewer_frame.png")
        with open(path, "wb") as f:
            f.write(frame())
        img = check_image("viewer frame", path, (CLI_SIZE, CLI_SIZE, 3))
        t1 = time.perf_counter()
        for _ in range(5):
            encode_png(img, level=1)
        print(f"viewer: PNG encoding of one frame on the host "
              f"{(time.perf_counter() - t1) / 5 * 1e3:.2f} ms")
        for query in ("tracer=pt_direct", "key=w"):
            wait(lambda: stats()["iteration"] >= 20, "20 frames")
            before, old = stats()["iteration"], frame()
            if get(f"/ctl?{query}")[0] != 204:
                raise PhaseError(f"viewer: /ctl?{query} refused")
            wait(lambda: stats()["iteration"] < before,
                 f"restart after {query}")
            wait(lambda: frame() != old, f"new frame after {query}")
            print(f"viewer /ctl?{query}: iteration {before} -> restart, "
                  "new frames")
            rate(f"after /ctl?{query}")
    finally:
        server.shutdown()
        serving.join(60)
        viewer.stop(server, state, render)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"viewer launches {counts}; server and render thread stopped: "
          f"{not serving.is_alive() and not render.is_alive()}")
    for k in ("primary_hit", "ris_cdf", "any_hit"):
        if counts[k] == 0:
            raise PhaseError(f"viewer: {k} never launched")


BANDS, MID = 3, 1  # phase 26: a 3-band split of 1080p, the middle band


def band_kernels(scene, cfg, cam, dev):
    """Phase 26 (a): B6, B7, B1b, B2 and B5 on the middle band of a
    3-band split of the headline frame 2 (static camera, live history),
    against their twins on the band and against the same kernels' whole
    frame at the band's pixels (bit for bit)."""
    w, h, r = cfg.width, cfg.height, cfg.num_pixels
    r_loc, window, halo_s = fused_sharding.band_layout(cfg, BANDS)
    pix0 = MID * r_loc
    prev_base = pix0 - window
    sl = slice(pix0, pix0 + r_loc)
    bvh, t = scene.bvh, scene.tables
    cv = pack_camera(cam, dev)
    gkw = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
               single_sided=cfg.single_sided_lights)
    ckw = dict(k=cfg.cdf_candidates, single_sided=cfg.single_sided_lights,
               has_met=cfg.scene_has_metallic, width=w)
    tkw = dict(k=cfg.cdf_candidates, temporal_clamp=cfg.temporal_clamp)
    print(f"row bands: {BANDS} bands of {r_loc} pixels ({r_loc // TILE} "
          f"tiles, {r_loc / w:.1f} rows) at {w}x{h}; band {MID} from pixel "
          f"{pix0}; temporal window {window}, spatial halo {halo_s}")

    def bands(x):
        return [x[:, i * r_loc:(i + 1) * r_loc] for i in range(BANDS)]

    def band(x):
        return x[:, sl].contiguous()

    # frames 0-2 of the whole frame through B6 + B7 + B1b
    pt1 = torch.zeros((PT_CH, r), device=dev)
    for looper in range(2):
        gb = gbuffer.gbuffer_cuda(cv, cv, looper, bvh, **gkw)
        rs = reuse.candidates_cuda(gb, looper, t, bvh, **ckw)
        pt1 = fused_di.temporal_cuda(gb, rs, pt1, looper, **tkw)
    gb2 = gbuffer.gbuffer_cuda(cv, cv, 2, bvh, **gkw)
    rs2 = reuse.candidates_cuda(gb2, 2, t, bvh, **ckw)
    pt2 = fused_di.temporal_cuda(gb2, rs2, pt1, 2, **tkw)
    prev_pt = fused_sharding.haloed(bands(pt1), MID, window, dev)
    bkw = dict(pix0=pix0, r=r_loc)
    times, fails = {}, []

    def same(name, got, whole):
        eq = bits_equal(got, band(whole)).all(0)
        share = float(eq.float().mean())
        print(f"band {name}: lanes equal to the whole-frame kernel's bit for "
              f"bit {share:.6f}")
        if share < 1.0:
            fails.append(f"{name} band differs from the whole frame on "
                         f"{1.0 - share:.6f} of its lanes")

    # B6
    gb_b = gbuffer.gbuffer_cuda(cv, cv, 2, bvh, **gkw, **bkw)
    fb, st = parity.gb_report(gbuffer.gbuffer_ref(cv, cv, 2, bvh, **gkw,
                                                  **bkw), gb_b)
    print(f"band B6 gbuffer_bvh vs twin: {json.dumps(st)}")
    fails += fb
    same("B6", gb_b, gb2)
    times["gbuffer_bvh"] = cuda_ms(lambda: gbuffer.gbuffer_cuda(
        cv, cv, 2, bvh, **gkw, **bkw), 20)
    # B7 and B1b, and their twin
    rs_b = reuse.candidates_cuda(gb_b, 2, t, bvh, pix0=pix0, **ckw)
    same("B7", rs_b, rs2)
    b1b = dict(pix0=pix0, prev_base=prev_base, window=window, **tkw)
    pt_b = fused_di.temporal_cuda(gb_b, rs_b, prev_pt, 2, **b1b)
    same("B1b", pt_b, pt2)
    if float(pt_b[P_M].max()) <= cfg.cdf_candidates:
        fails.append("band temporal merge inactive")
    pt_r = reuse.reuse_ref(gb_b, prev_pt, 2, t, k=cfg.cdf_candidates,
                           single_sided=cfg.single_sided_lights,
                           temporal_clamp=cfg.temporal_clamp,
                           has_met=cfg.scene_has_metallic, pix0=pix0,
                           prev_base=prev_base, window=window)
    fb, st = parity.pt_report(pt_r, pt_b)
    print(f"band B7 reuse_bvh + B1b vs twin: {json.dumps(st)}")
    fails += fb
    pt_tw = fused_di.temporal_pixels(
        gb_b, rs_b[RS_LI:RS_LI + 3], rs_b[RS_WI:RS_WI + 3], rs_b[RS_DIST],
        rs_b[RS_W], torch.arange(pix0, pix0 + r_loc, device=dev), 2,
        prev_pt, temporal=True, prev_base=prev_base, window=window, **tkw)
    close = parity.close_fraction(pt_tw, pt_b, 1e-6, 0.0)
    print(f"band B1b temporal vs twin: exact-close {close:.6f}")
    if close < 0.9999:
        fails.append(f"band B1b disagrees with its twin on {1 - close:.6f}")
    times["reuse_bvh"] = cuda_ms(lambda: reuse.candidates_cuda(
        gb_b, 2, t, bvh, pix0=pix0, **ckw), 20)
    times["temporal"] = cuda_ms(lambda: fused_di.temporal_cuda(
        gb_b, rs_b, prev_pt, 2, **b1b), 20)
    # B2 on the new pt pack with its spatial halo
    nb, rad = cfg.spatial_neighbors, cfg.spatial_radius
    acc0 = torch.as_tensor(np.random.default_rng(26).random(
        (3, r), dtype=np.float32), device=dev)
    skw = dict(width=w, height=h, neighbors=nb,
               has_met=cfg.scene_has_metallic)
    acc_w = spatial.spatial_shade_cuda(
        spatial.spatial_offsets(2, r, w, nb, rad, dev), gb2, pt2,
        acc0.clone(), 2, 3, **skw)
    offs_b = spatial.spatial_offsets(2, r_loc, w, nb, rad, dev, pix0=pix0,
                                     halo=halo_s, r_total=r)
    pt_ext = fused_sharding.haloed(bands(pt2), MID, halo_s, dev)
    gb2_b, pt2_b = band(gb2), band(pt2)
    b2kw = dict(pt_ext=pt_ext, pix0=pix0, **skw)
    acc_b = spatial.spatial_shade_cuda(offs_b, gb2_b, pt2_b, band(acc0), 2,
                                       3, **b2kw)
    same("B2", acc_b, acc_w)
    acc_r = spatial.spatial_shade_ref(offs_b, gb2_b, pt2_b, band(acc0), 2, 3,
                                      **b2kw)
    close = parity.close_fraction(acc_r, acc_b, 1e-5, 1e-6)
    print(f"band B2 spatial vs twin: close {close:.6f}")
    if close < 0.999:
        fails.append(f"band B2 disagrees with its twin on {1 - close:.5f}")
    scratch = band(acc0)
    times["spatial"] = cuda_ms(lambda: spatial.spatial_shade_cuda(
        offs_b, gb2_b, pt2_b, scratch, 2, 3, **b2kw), 20)
    # B5 on a seeded history with its temporal halo
    g = np.random.default_rng(27)
    prev = torch.as_tensor(g.random((svgf.SV_CH, r), dtype=np.float32),
                           device=dev)
    prev[svgf.SV_PRIM] = gb2[fused_di.G_PRIMR]
    prev[svgf.SV_NORM:svgf.SV_NORM + 3] = gb2[fused_di.G_NORM:
                                              fused_di.G_NORM + 3]
    color = torch.as_tensor(g.random((3, r), dtype=np.float32), device=dev)
    sv_w = svgf.svgf_temporal_cuda(gb2, color, prev)
    sv_prev = fused_sharding.haloed(bands(prev), MID, window, dev)
    vkw = dict(prev_base=prev_base, window=window)
    col_b = band(color)
    sv_b = svgf.svgf_temporal_cuda(gb2_b, col_b, sv_prev, **vkw)
    same("B5", sv_b, sv_w)
    close = parity.close_fraction(
        svgf.svgf_temporal_ref(gb2_b, col_b, sv_prev, **vkw), sv_b, 1e-6, 0.0)
    print(f"band B5 svgf_temporal vs twin: within rtol 1e-6 {close:.6f}")
    if close < 0.9999:
        fails.append(f"band B5 disagrees with its twin ({close:.6f})")
    times["svgf_temporal"] = cuda_ms(lambda: svgf.svgf_temporal_cuda(
        gb2_b, col_b, sv_prev, **vkw), 20)
    gate(fails, "row-band kernels")
    print("band kernel ms on the band (CUDA events, 20 launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


def banded_frames(scene, cfg, cam, dev, n, frames=3):
    """`frames` frames of the banded step on [dev] x n from init_state:
    the gathered frames."""
    mesh = parallel.make_mesh([dev] * n)
    step = parallel.make_fused_sharded_step(cfg, mesh)
    scenes = parallel.shard_scene(scene, mesh)
    state = parallel.shard_fused_state(
        restir_di_fused.init_state(cfg, cam, dev), mesh)
    out = []
    for _ in range(frames):
        state, frame = step(scenes, state, cam)
        out.append(parallel.gather(frame, dev))
    return out


def phase_bands(scene, cfg, cam, dev):
    """Phase 26: the fused frame over row bands on one card."""
    band_kernels(scene, cfg, cam, dev)
    # (b) 3 bands against one band, and against renderer.step (B1)
    for name, den in (("EAW", DenoiserType.EAW),
                      ("SVGF", DenoiserType.SVGF)):
        c = cfg.replace(denoiser=den)
        three = banded_frames(scene, c, cam, dev, BANDS)
        one = banded_frames(scene, c, cam, dev, 1)
        state = renderer.init_state(c, cam, scene, device=dev)
        for i in range(3):
            state, ref = renderer.step(scene, state, cam, c)
            if not torch.equal(three[i], one[i]):
                raise PhaseError(f"{name} frame {i}: 3 bands differ from "
                                 f"one band")
            if not bool(torch.isfinite(three[i]).all()):
                raise PhaseError(f"{name} frame {i}: non-finite values")
            exact = float(bits_equal(three[i], ref).all(0).float().mean())
            close = bool(torch.allclose(three[i], ref, rtol=1e-5, atol=1e-6))
            print(f"row bands {name} frame {i}: 3 bands == 1 band bit "
                  f"for bit; lanes equal to renderer.step's (B1) {exact:.6f},"
                  f" within rtol 1e-5 / atol 1e-6: {close}")
            if not close:
                raise PhaseError(f"{name} frame {i}: bands disagree with "
                                 f"renderer.step beyond rtol 1e-5")
    # (c) the 3-band EAW path, timed
    mesh = parallel.make_mesh([dev] * BANDS)
    step = parallel.make_fused_sharded_step(cfg, mesh)
    scenes = parallel.shard_scene(scene, mesh)
    reset_counts()
    state = parallel.shard_fused_state(
        restir_di_fused.init_state(cfg, cam, dev), mesh)
    for _ in range(WARMUP):
        state, frame = step(scenes, state, cam)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED):
        state, frame = step(scenes, state, cam)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED
    dev_ms = start.elapsed_time(end) / TIMED
    counts = read_counts()
    per_frame = {"gbuffer_bvh": BANDS, "reuse_bvh": BANDS,
                 "ris_search": BANDS, "temporal": BANDS, "spatial": BANDS,
                 "atrous_eaw": BANDS * cfg.eaw_levels}
    expect = {k: per_frame.get(k, 0) * (WARMUP + TIMED) for k in counts}
    print(f"main path headline {BANDS} bands launches {counts} (expected "
          f"{expect})")
    if counts != expect:
        raise PhaseError(f"row bands: launch counts {counts} != {expect}")
    img = parallel.gather(frame, dev)
    if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0.0:
        raise PhaseError("row bands: the frame is not finite or is black")
    m = parallel.gather(state.pt_pack, dev)[P_M]
    m_mean = float(m[m > 0].mean())
    if not m_mean > 2 * cfg.cdf_candidates:
        raise PhaseError(f"row bands: temporal reuse not alive ({m_mean})")
    fps = 1e3 / wall_ms
    print(f"main path headline {BANDS} bands {cfg.width}x{cfg.height} "
          f"RESTIR_DI+EAW: {wall_ms:.3f} ms/frame wall, {dev_ms:.3f} "
          f"ms/frame device, {fps:.3f} fps, "
          f"{2 * cfg.num_pixels * fps / 1e6:.3f} Mrays/s; mean M "
          f"{m_mean:.2f} (phase 6, one device, B1: "
          f"{MAIN_WALL['headline']:.3f} ms/frame wall)")
    profile_frames(f"headline {BANDS} bands", scene, cfg, cam, dev,
                   step=lambda s: step(scenes, s, cam)[0], state=state)


def general_band_kernels(scene, cam, dev):
    """Phase 27 (a): B10 and B9 on the middle band of a 3-band split of
    the headline's general frame at 1080p (whole rows; a camera that
    turned 0.5 degrees, so B9's motion reaches the next band's rows),
    against the same kernels' whole frame at the band's pixels (bit for
    bit) and against their twins on the band."""
    w, h = WIDTH, HEIGHT
    r = w * h
    r_loc = sharding.general_layout(RenderConfig(width=w, height=h), BANDS)
    pix0 = MID * r_loc
    sl = slice(pix0, pix0 + r_loc)
    t = scene.tables
    fails, times = [], {}
    print(f"general row bands: {BANDS} bands of {r_loc} pixels "
          f"({h // BANDS} rows, {r_loc // gi.TILE} B9 tiles) at {w}x{h}; "
          f"band {MID} from pixel {pix0}")

    def same(name, got, whole):
        eq = float(bits_equal(got, whole[:, sl]).all(0).float().mean())
        print(f"general band {name}: lanes equal to the whole-frame "
              f"kernel's bit for bit {eq:.6f}")
        if eq < 1.0:
            fails.append(f"{name} band differs from the whole frame on "
                         f"{1.0 - eq:.6f} of its lanes")

    # B10 on the general G-buffer pack (phase 12's)
    dcfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_DI)
    pack, shade = b10_input(scene, cam, dev, w, h)
    kw = dict(k=dcfg.cdf_candidates, single_sided=dcfg.single_sided_lights,
              has_met=dcfg.scene_has_metallic)
    band = pack[:, sl].contiguous()
    k10 = ris_cdf.ris_cdf_cuda(band, 1, t, scene.bvh, pix0=pix0, **kw)
    same("B10", k10, ris_cdf.ris_cdf_cuda(pack, 1, t, scene.bvh, **kw))
    r10 = ris_cdf.ris_cdf_ref(band, 1, t, pix0=pix0, **kw)
    li, wi_, w_ = ris_cdf.OUT_LI, ris_cdf.OUT_WI, ris_cdf.OUT_W
    pick = (torch.all(k10[li:li + 3] == r10[li:li + 3], 0)
            & torch.all(torch.isclose(k10[wi_:wi_ + 3], r10[wi_:wi_ + 3],
                                      rtol=2e-4, atol=1e-5), 0))
    s_b = shade[sl]
    pm = float(pick[s_b].float().mean())
    wclose = float(torch.isclose(k10[w_][pick & s_b], r10[w_][pick & s_b],
                                 rtol=2e-4, atol=1e-7).float().mean())
    m_eq = float((k10[ris_cdf.OUT_M] == r10[ris_cdf.OUT_M]).float().mean())
    print(f"general band B10 vs twin: pick match {pm:.6f}, weights within "
          f"rtol 2e-4 {wclose:.6f}, M equal {m_eq:.6f}")
    if pm < 0.995 or wclose < 0.999 or m_eq < 0.9999:
        fails.append("band B10 disagrees with its twin")
    times["ris_cdf"] = cuda_ms(lambda: ris_cdf.ris_cdf_cuda(
        band, 1, t, scene.bvh, pix0=pix0, **kw), 20)
    del pack, band, r10

    # B9: frame 0 from a zero pack, frame 1 after the camera turned
    gcfg = RenderConfig(width=w, height=h, tracer=TracerType.RESTIR_GI,
                        trace_depth=5)
    tkw = restir_gi.trace_kwargs(scene, gcfg)
    moved = update_camera(cam, rotation=(-90.0, -9.5, 0.0))
    q = torch.zeros((gi.Q_CH, r), device=dev)
    for looper, (c, last) in enumerate(((cam, cam), (moved, cam))):
        gb, it, gmat, ray_dir = general_gb.render_gbuffer(scene, c, last,
                                                          gcfg, looper)
        in_pack = restir_gi._build_gi_in_pack(it, gmat, ray_dir)
        go = gi.gi_trace_cuda(in_pack, looper, scene, **tkw)
        gq = restir_gi._gq_pack(gb, it)
        prev = q
        ind, q = gi.gi_resolve_cuda(go, in_pack, gq, q, looper)
    (lo, hi), = sharding.motion_ranges(
        [gb._replace(**{f: getattr(gb, f)[sl] for f in gb._fields})], r,
        dev)
    print(f"general band B9: the band's motion reaches previous pixels "
          f"[{lo}, {hi}) (rows {lo // w}-{(hi - 1) // w}; the band holds "
          f"rows {pix0 // w}-{(pix0 + r_loc) // w - 1})")
    if lo >= pix0 and hi <= pix0 + r_loc:
        fails.append("B9's band motion does not reach another band")
    args = (go[:, sl].contiguous(), in_pack[:, sl].contiguous(),
            gq[:, sl].contiguous(), prev[:, lo:hi].contiguous(), 1)
    bkw = dict(pix0=pix0, prev_base=lo, r_prev=r)
    ind_b, q_b = gi.gi_resolve_cuda(*args, **bkw)
    same("B9 indirect", ind_b, ind)
    same("B9 pack", q_b, q)
    ind_r, q_r = gi.gi_resolve_ref(*args, **bkw)
    m_eq = float((q_b[gi.Q_M] == q_r[gi.Q_M]).float().mean())
    w_ok = lanes(q_b[gi.Q_W:gi.Q_W + 1], q_r[gi.Q_W:gi.Q_W + 1], 1e-5, 1e-7)
    i_ok = lanes(ind_b, ind_r, 1e-3, 1e-6)
    exact = float(bits_equal(q_b, q_r).all(0).float().mean())
    print(f"general band B9 vs twin: M equal {m_eq:.6f}, W within rtol 1e-5 "
          f"{w_ok:.6f}, indirect within rtol 1e-3 {i_ok:.6f}, exact lanes "
          f"{exact:.6f}, max M {float(q_b[gi.Q_M].max()):.0f}")
    if min(m_eq, w_ok, i_ok) < 0.9999:
        fails.append("band B9 disagrees with its twin")
    times["gi_resolve"] = cuda_ms(lambda: gi.gi_resolve_cuda(*args, **bkw),
                                  20)
    gate(fails, "general row-band kernels")
    print("general band kernel ms on the band (CUDA events, 20 launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


def general_banded(scene, cfg, cams, dev, n, init):
    """The frames of `make_sharded_step` on [dev] x n from init(), one per
    camera of `cams`, gathered."""
    mesh = parallel.make_mesh([dev] * n)
    state = init()
    step = parallel.make_sharded_step(cfg, mesh, state)
    scenes = parallel.shard_scene(scene, mesh)
    state = parallel.shard_state(state, mesh, cfg)
    out = []
    for c in cams:
        state, frame = step(scenes, state, c)
        out.append(parallel.gather(frame, dev, dim=0))
    return out


def exchange_ms(scene, cfg, cams, dev):
    """Device ms of one frame's copies between 3 bands of `cfg` after
    frames with `cams`: the previous frame's pixel ranges each band's
    motion reaches (and its host read, on the host's clock), and the
    row halos of the spatial merge and of the EAW images."""
    mesh = parallel.make_mesh([dev] * BANDS)
    state = renderer.init_general(cfg, cams[0], dev, scene)
    step = parallel.make_sharded_step(cfg, mesh, state)
    state = parallel.shard_state(state, mesh, cfg)
    for c in cams[:-1]:
        state, _ = step(scene, state, c)
    bands = [sharding.band_state(state, b) for b in range(BANDS)]
    r_loc = cfg.num_pixels // BANDS
    prim = [renderer.general_gbuffer(scene, bands[b], cams[-1], cfg,
                                     b * r_loc, r_loc) for b in range(BANDS)]
    gbs = [p[0] for p in prim]
    packs = [renderer.previous_packs(s, cfg) for s in bands]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        ranges = sharding.motion_ranges(gbs, cfg.num_pixels, dev)
    read_ms = (time.perf_counter() - t0) * 1e2
    fetch = cuda_ms(lambda: [sharding.fetch_columns(packs, r_loc, lo, hi,
                                                    dev)
                             for lo, hi in ranges], 10)
    px = sum(hi - lo for lo, hi in ranges)
    ch = sum(p.shape[0] for p in packs[0].values())
    sp = [restir_di.spatial_pack(bands[b].dir_reservoir, gbs[b])
          for b in range(BANDS)]
    gbp = [denoiser.gbuffer_pack(g) for g in gbs]
    col = [torch.zeros((3, r_loc), device=dev) for _ in range(BANDS)]
    halo_s = int(np.ceil(cfg.spatial_radius))
    halo_d = sharding.denoise_halo_rows(cfg)
    w, h = cfg.width, cfg.height

    def halos():
        for b in range(BANDS):
            sharding.row_image(sp, b, halo_s, w, h, dev)
            sharding.row_image(gbp, b, halo_d, w, h, dev)
            sharding.row_image(col, b, halo_d, w, h, dev)

    halo = cuda_ms(halos, 10)
    return read_ms, fetch, halo, px, ch, ranges


def phase_general_bands(scene, arrays, cam, dev):
    """Phase 27: the general frame over row bands on one card."""
    general_band_kernels(scene, cam, dev)
    flags = mat_flags(arrays)
    base = RenderConfig(width=WIDTH, height=HEIGHT, **flags)
    di = base.replace(tracer=TracerType.RESTIR_DI)
    still = [cam] * 3
    turning = [update_camera(cam, rotation=(-90.0, -10.0 + 0.5 * i, 0.0))
               for i in range(3)]
    # (b) 3 bands against one band and against renderer.step_general
    configs = [
        ("general DI cdf + EAW", di.replace(denoiser=DenoiserType.EAW),
         still),
        ("general DI + SVGF, camera turning", di.replace(
            denoiser=DenoiserType.SVGF), turning),
        ("general GI + resolve pack", base.replace(
            tracer=TracerType.RESTIR_GI, trace_depth=5,
            denoiser=DenoiserType.NONE), still),
        ("PT_DIRECT", base.replace(tracer=TracerType.PT_DIRECT,
                                   denoiser=DenoiserType.NONE), still),
        ("GBUFFER_PREVIEW depth", base.replace(
            tracer=TracerType.GBUFFER_PREVIEW, gbuffer_channel="depth",
            denoiser=DenoiserType.NONE), still),
    ]
    for name, c, cams in configs:
        def init(c=c, cams=cams):
            return renderer.init_general(c, cams[0], dev, scene)
        if (c.tracer == TracerType.RESTIR_GI
                and not isinstance(init().gi_reservoir, torch.Tensor)):
            raise PhaseError(f"{name}: no resolve pack")
        three = general_banded(scene, c, cams, dev, BANDS, init)
        one = general_banded(scene, c, cams, dev, 1, init)
        state = init()
        for i, cm in enumerate(cams):
            state, ref = renderer.step_general(scene, state, cm, c)
            if not torch.equal(three[i], one[i]):
                raise PhaseError(f"{name} frame {i}: 3 bands differ from "
                                 f"one band")
            if not bool(torch.isfinite(three[i]).all()):
                raise PhaseError(f"{name} frame {i}: non-finite values")
            exact = float(bits_equal(three[i], ref).all(1).float().mean())
            close = bool(torch.allclose(three[i], ref, rtol=1e-5, atol=1e-6))
            print(f"general row bands {name} frame {i}: 3 bands == 1 band "
                  f"bit for bit; lanes equal to renderer.step_general's "
                  f"{exact:.6f}, within rtol 1e-5 / atol 1e-6: {close}; "
                  f"frame mean {float(three[i].mean()):.5f}")
            if not close:
                raise PhaseError(f"{name} frame {i}: bands disagree with "
                                 f"renderer.step_general beyond rtol 1e-5")
        if not float(three[-1].mean()) > 0.0:
            raise PhaseError(f"{name}: the frame is black")
    # the copies between bands, camera still and turning
    c = di.replace(denoiser=DenoiserType.EAW)
    for what, cams in (("still", still), ("turning", turning)):
        read_ms, fetch, halo, px, ch, ranges = exchange_ms(scene, c, cams,
                                                           dev)
        print(f"general row bands copies per frame, camera {what}: motion "
              f"ranges {ranges} read to the host in {read_ms:.3f} ms (host "
              f"clock); fetch of {px} previous pixels x {ch} channels "
              f"{fetch:.4f} ms; spatial + EAW row halos {halo:.4f} ms "
              f"(CUDA events)")
    # (c) the 3-band general DI cdf + EAW path, timed, beside one device
    per_frame = {"primary_hit": BANDS, "ris_cdf": BANDS,
                 "ris_search": BANDS, "atrous_eaw": BANDS * c.eaw_levels}
    phase_general_main("general DI cdf + EAW, one device", scene, c, cam,
                       dev, {k: v // BANDS for k, v in per_frame.items()},
                       GENERAL_WARMUP, GENERAL_TIMED, with_scene=False)
    mesh = parallel.make_mesh([dev] * BANDS)
    state = renderer.init_general(c, cam, dev, scene)
    step = parallel.make_sharded_step(c, mesh, state)
    state = parallel.shard_state(state, mesh, c)
    scenes = parallel.shard_scene(scene, mesh)
    reset_counts()
    for _ in range(GENERAL_WARMUP):
        state, frame = step(scenes, state, cam)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(GENERAL_TIMED):
        state, frame = step(scenes, state, cam)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / GENERAL_TIMED
    event_ms = start.elapsed_time(end) / GENERAL_TIMED
    counts = read_counts()
    expect = {k: per_frame.get(k, 0) * (GENERAL_WARMUP + GENERAL_TIMED)
              for k in counts}
    print(f"main path general DI cdf + EAW {BANDS} bands launches {counts} "
          f"(expected {expect})")
    if counts != expect:
        raise PhaseError(f"general row bands: launch counts {counts} != "
                         f"{expect}")
    img = parallel.gather(frame, dev, dim=0)
    if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0.0:
        raise PhaseError("general row bands: the frame is not finite or is "
                         "black")
    print(f"main path general DI cdf + EAW {BANDS} bands {c.width}x"
          f"{c.height}: {wall_ms:.3f} ms/frame wall, {event_ms:.3f} "
          f"ms/frame between CUDA events (the step reads the motion ranges "
          f"to the host every frame, so this follows the wall; the device "
          f"busy time is the profile's below), {1e3 / wall_ms:.3f} fps (one "
          f"device, same run: "
          f"{MAIN_WALL['general DI cdf + EAW, one device']:.3f} ms/frame "
          f"wall; phase 13 general DI cdf without a denoiser: "
          f"{MAIN_WALL.get('general DI cdf', float('nan')):.3f})")
    profile_frames(f"general DI cdf + EAW {BANDS} bands", scene, c, cam, dev,
                   step=lambda s: step(scenes, s, cam)[0], state=state)


PROBE_LAUNCHES = {  # SOURCES name -> restir_tpu_torch.prof.kernels counter
    "prof_key": "key", "prof_radix_sort": "radix_sort",
    "prof_gather": "gather", "prof_scatter": "scatter", "prof_copy": "copy",
    "prof_anyhit_fma": "anyhit_fma", "prof_anyhit_mma3": "anyhit_mma3",
    "prof_anyhit_mma6": "anyhit_mma6",
    "prof_table_gather_shared": "table_gather_shared",
    "prof_table_gather_ldg": "table_gather_ldg",
    "prof_table_gather_tex": "table_gather_tex",
    "prof_chain_soa": "chain_soa", "prof_chain_aos": "chain_aos",
    "prof_chain_float4": "chain_float4"}


def probe_record(ms, plain_ms, nbytes, flops, library_ms, err,
                 tensor_flops=0.0):
    """A kernels-line record: the bound is the larger of the bytes' time
    and the operations' time, the larger of FP32 operations at PEAK_FLOPS
    and tensor operations at PEAK_TF32 (the two pipes run side by side)."""
    ms_b = nbytes / PEAK_BYTES * 1e3
    ms_f = max(flops / PEAK_FLOPS, tensor_flops / PEAK_TF32) * 1e3
    b, by = (ms_b, "bytes") if ms_b >= ms_f else (ms_f, "operations")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=library_ms)


def probe_ms(fns, reps=5, rounds=2, warmup=1):
    """{name: (device ms, CUDA-event ms)} a call: the least over `rounds`
    interleaved rounds of `reps` calls (restir_tpu_torch.prof._timing:
    each call's kernels and copies summed in a torch.profiler trace; the
    events around back-to-back calls, which measure the wrapper's host
    time where its kernels are shorter)."""
    from restir_tpu_torch.prof import _timing

    t = _timing.interleaved(fns, "cuda", rounds=rounds, reps=reps,
                            warmup=warmup)
    return {k: (min(v.device), min(v.events)) for k, v in t.items()}


def probe_line(name, rec, events):
    print(f"{name}: kernel {rec['ms']:.4f} ms (events {events:.4f}), twin "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max err "
          f"{rec['max_abs_err']}")


def probe_ray_order(dev, record, fails):
    """Phase 28 (a), ray order on the hall's 1080p NEE segments: in each
    key order the key, the sort, the [9, R] pack's gather, the gather of
    B13's inputs, the scatter of its flags and the copy against their
    twins bit for bit; the sort on 3840x2160 keys (the hall's four
    times over, ties across the copies); device times and bounds of the
    direction-then-origin order (prof_take's and the records'), the
    sort's launches one by one."""
    from restir_tpu_torch.prof import _scenes as pscenes
    from restir_tpu_torch.prof import _trace
    from restir_tpu_torch.prof import kernels as pk
    from restir_tpu_torch.prof import prof_take

    fr = pscenes.hall(dev)
    trv = intersect.traversal_arrays(fr.scene, "bvh")
    pos, target, live = pscenes.nee_segments(fr, trv)
    lo, hi = pscenes.scene_box(fr)
    r = pos.shape[0]
    pack = prof_take.segment_pack(pos, target, live)
    c = pack.shape[0]
    flags = hits.any_hit(trv, pos, target, live)
    for order in pk.KEY_ORDERS:
        key = pk.coherence_key(pos, target, live, lo, hi, order)
        if not torch.equal(key, pk.coherence_key_ref(pos, target, live, lo,
                                                     hi, order)):
            fails.append(f"the {order} key differs from its twin")
        vals, perm = pk.radix_sort(key)
        rv, rp = pk.radix_sort_ref(key)
        if not (torch.equal(vals, rv) and torch.equal(perm, rp)):
            fails.append(f"the sort of the {order} keys differs from "
                         "torch.sort(stable=True)")
        pl = perm.long()
        g = pk.gather_cols(pack, perm)
        if not torch.equal(g, pack.index_select(1, pl)):
            fails.append(f"the {order} gather differs from index_select")
        if not torch.equal(pk.scatter_cols(g, perm), pack):
            fails.append(f"the {order} scatter of the pack is not the "
                         "gather's inverse")
        x, y, sl = pk.gather_rays(perm, pos, target, live)
        if not (torch.equal(x, pos[pl]) and torch.equal(y, target[pl])
                and torch.equal(sl, live[pl])):
            fails.append(f"the {order} gather of B13's inputs differs")
        sf = flags[pl]
        want = torch.empty_like(sf)
        want[pl] = sf
        if not (torch.equal(pk.scatter_cols(sf, perm), want)
                and torch.equal(want, flags)):
            fails.append(f"the {order} scatter of the flags differs")
    if not torch.equal(pk.copy_pack(pack), pack):
        fails.append("the copy differs from its source")
    big = torch.cat([key] * 4)  # 3840 x 2160 keys
    bv, bp = pk.radix_sort(big)
    brv, brp = pk.radix_sort_ref(big)
    if not (torch.equal(bv, brv) and torch.equal(bp, brp)):
        fails.append(f"the sort of {big.shape[0]} keys differs from "
                     "torch.sort(stable=True)")
    print(f"probe ray order on the hall's {r} NEE segments ({c}-channel "
          f"pack; the last order {order}): key, sort, "
          f"gathers, scatters and copy equal to their twins in every order, "
          f"the sort of {big.shape[0]} keys to torch.sort: {not fails}")
    gate(fails, "ray-order kernels")

    def traced_count(fn, tries=3):
        """The sort's kernels (by name) in a torch.profiler trace of one
        call of fn, its step opened by a few fills after a discarded
        warm-up step (a trace may miss the first kernels after it
        starts): the most of `tries`."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        most = 0
        lead = torch.empty(1, device=dev)
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    for _ in range(4):
                        lead.fill_(0.0)
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            most = max(most, sum(
                e.device_type == DeviceType.CUDA
                and ("hist_kernel" in e.name or "onesweep_kernel" in e.name)
                for e in prof.events()))
        return most

    # the gate: the C entry point's own count of the launches the runtime
    # took; the trace's count beside it must not exceed it
    n0 = pk.sort_kernel_launches()
    pk.radix_sort(key)
    torch.cuda.synchronize()
    n = pk.sort_kernel_launches() - n0
    nt = traced_count(lambda: pk.radix_sort(key))
    print(f"probe sort: {n} launches a sort (1 + {pk.SORT_PASSES} passes; "
          f"{nt} of the sort's kernels in a trace of one sort)")
    if n != 1 + pk.SORT_PASSES:
        raise PhaseError(f"the sort launched {n} kernels, not "
                         f"1 + {pk.SORT_PASSES}")
    if nt > n:
        raise PhaseError(f"a trace of one sort holds {nt} of its kernels, "
                         f"more than the {n} it launched")
    ms, _ = _trace.kernel_ms(lambda: pk.radix_sort(key), 5, dev)
    print(f"probe sort ({pk.SORT_PASSES} passes of {pk.SORT_BITS}-bit "
          f"digits; device ms a sort, by kernel name, summed over its "
          f"passes): " + ", ".join(
              f"{'hist' if 'hist_kernel' in k else 'passes'} {v:.4f}"
              for k, v in ms.items()))
    t = probe_ms({
        "key": lambda: pk.coherence_key(pos, target, live, lo, hi, order),
        "key_ref": lambda: pk.coherence_key_ref(pos, target, live, lo, hi,
                                                order),
        "sort": lambda: pk.radix_sort(key),
        "sort_ref": lambda: pk.radix_sort_ref(key),
        "torch.sort": lambda: torch.sort(key, stable=True),
        "sort_big": lambda: pk.radix_sort(big),
        "torch.sort_big": lambda: torch.sort(big, stable=True),
        "gather": lambda: pk.gather_cols(pack, perm),
        "gather_ref": lambda: pack.index_select(1, perm.long()),
        "index_select": lambda: pack.index_select(1, pl),
        "gather_rays": lambda: pk.gather_rays(perm, pos, target, live),
        "scatter": lambda: pk.scatter_cols(sf, perm),
        "scatter_ref": lambda: torch.empty_like(sf).index_put_(
            (perm.long(),), sf),
        "index_copy_": lambda: torch.empty_like(sf).index_copy_(0, pl, sf),
        "copy": lambda: pk.copy_pack(pack),
        "copy_ref": lambda: pack.clone(),
        "copy_": lambda: torch.empty_like(pack).copy_(pack)})
    ms = {k: v[0] for k, v in t.items()}
    record["prof_key"] = probe_record(
        ms["key"], ms["key_ref"], 29 * r, FLOP_KEY * r, None, 0.0)
    record["prof_radix_sort"] = probe_record(
        ms["sort"], ms["sort_ref"], 12 * r, 0.0, ms["torch.sort"], 0.0)
    record["prof_gather"] = probe_record(
        ms["gather"], ms["gather_ref"], 8 * c * r + 4 * r, 0.0,
        ms["index_select"], 0.0)
    # the flags: a byte read and written a ray, and the permutation
    record["prof_scatter"] = probe_record(
        ms["scatter"], ms["scatter_ref"], 6 * r, 0.0, ms["index_copy_"], 0.0)
    record["prof_copy"] = probe_record(
        ms["copy"], ms["copy_ref"], 8 * c * r, 0.0, ms["copy_"], 0.0)
    for name in ("prof_key", "prof_radix_sort", "prof_gather", "prof_scatter",
                 "prof_copy"):
        probe_line(name, record[name], t[name[5:].replace("radix_", "")][1])
    bb = big.shape[0]
    print(f"probe ray order, device ms (events ms) a call, warm in L2 "
          f"(back-to-back calls on the same inputs): sort of {bb} keys "
          f"{ms['sort_big']:.4f} "
          f"({t['sort_big'][1]:.4f}) against torch.sort(stable) "
          f"{ms['torch.sort_big']:.4f}, bound "
          f"{12 * bb / PEAK_BYTES * 1e3:.4f}; the gather of B13's inputs "
          f"{ms['gather_rays']:.4f} ({t['gather_rays'][1]:.4f}), bound "
          f"{(4 * r + 25 * r * 2) / PEAK_BYTES * 1e3:.4f} (bytes: perm, "
          f"25 bytes read and written a ray)")


def stage_bounds(dev):
    """Phase 28 (a): the bounds of B7's and B10's stage builds (the
    shadow walks split, restir_tpu_torch.prof vissplit / hallsplit) from
    the work each build does on frame 1: search-only the RIS and no walk,
    fixed-node the full walk's box and leaf tests (it reads their counts),
    no-leaf and no-exit their own, counted by a counting launch of the
    build (`csrc/prof/walk_probe.cuh`)."""
    from restir_tpu_torch.prof import _scenes as pscenes
    from restir_tpu_torch.prof import prof_vissplit

    def report(what, counts, fn):
        for mode, c in counts.items():
            b = fn(c)
            r = c.shape[1]
            print(f"stage bound {what} {mode}: {b[0]:.4f} ms ({b[1]}; "
                  f"{float(c[0].double().sum()) / r:.2f} box and "
                  f"{float(c[1].double().sum()) / r:.2f} leaf tests a pixel)")

    def modes(full, call, builds):
        counts = {"full": full, "search-only": torch.zeros_like(full),
                  "fixed-node": full}
        for mode, var in builds.items():
            counts[mode] = call(_build.variant_library(var))
        return counts

    for fr in (pscenes.hall(dev), pscenes.hall(dev, sky=True)):
        gb = pscenes.gb_pack(fr)
        t, bvh, kw = fr.scene.tables, fr.scene.bvh, fr.rkw()

        def b7(lib=None):
            return reuse.candidates_cuda(gb, 1, t, bvh, width=fr.cfg.width,
                                         stats=True, lib=lib, **kw)[1]

        report(f"B7 {fr.name}", modes(b7(), b7, {
            "no-leaf": "b7_no_leaf", "no-exit": "b7_no_exit"}),
            lambda c: walk_bound7(t, bvh, gb.shape[1], kw["k"], c,
                                  kw["has_env"]))
    for fr in (pscenes.hall(dev), pscenes.headline(dev)):
        pack = prof_vissplit.b10_pack(fr)
        t, bvh, c = fr.scene.tables, fr.scene.bvh, fr.cfg
        kw = dict(k=c.cdf_candidates, single_sided=c.single_sided_lights,
                  has_met=c.scene_has_metallic)
        r = pack.shape[1]

        def b10(lib=None):
            return ris_cdf.ris_cdf_cuda(pack, 1, t, bvh, stats=True, lib=lib,
                                        **kw)[1]

        def b10_bound(cnt):
            boxes, tests = (float(x.double().sum()) for x in cnt[:2])
            return ris_bound10(t, r, kw["k"], boxes, tests,
                               table_bytes(bvh.planes, bvh.rows))

        report(f"B10 {fr.name}", modes(b10(), b10,
                                       {"no-leaf": "b10_no_leaf"}),
               b10_bound)


def anyhit_sass_report(fn, pairs):
    """The tensor-core any hit's step loop (`sass_loops`' smallest loop
    that issues HGMMA) in each build: its instructions by opcode, their
    issue time (one instruction a clock per SM sub-partition, a warp's
    step testing 16 rays x 32 rows, at the SM clock nvidia-smi reads
    while fn runs for half a second) beside the wgmmas' tensor time at
    PEAK_TF32 (64 x 96 x 8 multiply-adds each, 4 a step in 3xTF32, 6 in
    6xTF32)."""
    mhz = sm_clock_mhz(fn, seconds=0.5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    loops = sass_loops(_build._variant_path("prof"), "anyhit_mma_kernel")
    for name, ls in sorted(loops.items()):
        steps = [lp["ops"] for lp in ls if lp["ops"]["HGMMA"]]
        if not steps:
            print(f"probe any hit SASS {name[-40:]}: no HGMMA loop")
            continue
        ops = min(steps, key=lambda c: sum(c.values()))
        n = sum(ops.values())
        issue_ms = n * pairs / 512 / (sms * 4) / (mhz * 1e6) * 1e3
        tensor_ms = ops["HGMMA"] * 64 * 96 * 8 * 2 * pairs / 2048 \
            / PEAK_TF32 * 1e3
        print(f"probe any hit SASS {name[-40:]}: step loop {n} "
              f"instructions a warp ({n / 512:.3f} a pair): "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(10))
              + f"; issue {issue_ms:.4f} ms at {mhz:.0f} MHz on {sms} SMs, "
              f"tensor {tensor_ms:.4f} ms at 495 TFLOP/s")


def fma_sass_report(fn, pairs):
    """The FP32 any hit's row loops (the innermost loops of
    `anyhit_fma_kernel` that divide; the widest is the several-rays-a-lane
    loop, the other the share's one-ray tail): instructions a pair (a
    loop's common path over its divisions, one MUFU.RCP a pair) by
    opcode, and the issue time of `pairs` pairs at that rate (one warp
    instruction a clock per SM sub-partition) at the SM clock nvidia-smi
    reads while fn runs for half a second."""
    mhz = sm_clock_mhz(fn, seconds=0.5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build._variant_path("prof")
    for name, ls in sorted(sass_loops(lib, "anyhit_fma_kernel").items()):
        rows = [lp for lp in ls if lp["ops"]["MUFU"]]
        inner = [lp for lp in rows if not any(
            o is not lp and int(lp["start"], 16) <= int(o["start"], 16)
            and int(o["end"], 16) <= int(lp["end"], 16) for o in rows)]
        for lp in sorted(inner, key=lambda lp: -lp["ops"]["MUFU"]):
            div = lp["ops"]["MUFU"]
            per = lp["common"]["all"] / div
            issue_ms = per * pairs / 32 / (sms * 4) / (mhz * 1e6) * 1e3
            print(f"probe any hit fma SASS {name[-30:]} loop "
                  f"{lp['start']}-{lp['end']}: {div} pairs a lane a step, "
                  f"{lp['common']['all']} instructions on its common path "
                  f"({lp['whole']['all']} in all), {per:.2f} a pair; the "
                  f"whole loop's a pair by opcode: "
                  + ", ".join(f"{k} {v / div:.2f}"
                              for k, v in lp["ops"].most_common(14))
                  + f"; issue {issue_ms:.4f} ms for {pairs} pairs at "
                  f"{mhz:.0f} MHz on {sms} SMs")


def chain_sass_report(fns, pixels, rounds=90):
    """Each chain kernel's SASS (the rounds unrolled: the whole function,
    less its padding, is one pixel's work): instructions a pixel by
    opcode, FMUL and FADD a round, and
    the issue time of `pixels` pixels (one warp instruction a clock per
    SM sub-partition) at the SM clock nvidia-smi reads while its layout's
    call (fns[layout]) runs for half a second."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build._variant_path("prof")
    kernels = {"soa": "chain_soa_kernel", "aos": "chain_aos_kernel",
               "float4": "chain_f4_kernel"}
    for layout, kernel in kernels.items():
        mhz = sm_clock_mhz(fns[layout], seconds=0.5)
        for name, code in _sass_functions(lib, kernel).items():
            # less the padding after the end: NOPs and the branch to itself
            run = [r for r in code
                   if r[1] != "NOP" and not (r[1] == "BRA" and r[3] == r[0])]
            ops = collections.Counter(r[1] for r in run)
            n = len(run)
            loops = [lp["whole"]["all"] for lp in
                     sass_loops(lib, kernel).get(name, [])]
            issue_ms = n * pixels / 32 / (sms * 4) / (mhz * 1e6) * 1e3
            fp = (ops["FMUL"] + ops["FADD"]) / rounds
            print(f"probe chain {layout} SASS {name[-30:]}: {n} instructions "
                  f"a pixel, FMUL + FADD {fp:.2f} a round (loops {loops}): "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(10))
                  + f"; issue {issue_ms:.4f} ms for {pixels} pixels at "
                  f"{mhz:.0f} MHz on {sms} SMs")


def phase_probes(dev, record, launches):
    """Phase 28: the stage probes (restir_tpu_torch.prof). (a) Each new
    kernel of csrc/prof/ against its plain twin at the shapes its probe
    gives it (1920x1080; the hall's NEE segments for the key, the sort,
    the gather and the copy; the headline scene's 512 padded plane rows
    for the any hit; R = 1920 x 1088, K = 1024 and 8192 for the table
    gathers, the kernels line K = 8192's):
    the key, the sort's permutation, the gathers, the scatters and the
    chains bit for bit (`probe_ray_order`), the any hit's two forms
    within the reference's primitive gate (mismatch <= 0.2 %; FP32 and
    6xTF32 against each other too, 3xTF32's mismatch against FP32
    printed); kernel, twin and PyTorch-call device times (`probe_ms`)
    and bounds; the stage builds' bounds (`stage_bounds`).
    (b) Each stage probe's `full` build (B6, B7, B10 from their sources
    without a PROBE macro) against the main library, bit for bit. (c)
    The slice's main path: `python -m restir_tpu_torch.prof all` in this
    process (every probe once, 1 warm-up and 5 timed launches per row),
    its launch counts read after it."""
    from restir_tpu_torch.prof import __main__ as prof_main
    from restir_tpu_torch.prof import _scenes as pscenes
    from restir_tpu_torch.prof import kernels as pk
    from restir_tpu_torch.prof import (
        prof_fma,
        prof_gather,
        prof_gvariants,
        prof_v3,
        prof_vissplit,
    )

    t0 = time.perf_counter()
    fails = []
    probe_ray_order(dev, record, fails)
    events = {}

    hfr = pscenes.headline(dev)
    xform = intersect.traversal_arrays(hfr.scene, "brute").tri_xform
    planes = pk.plane_rows(xform, prof_fma.N_PAD)
    rays = prof_fma.random_rays(*pscenes.scene_box(hfr), WIDTH * HEIGHT,
                                dev)
    nr = rays.shape[1]
    splits = {"fma": None, "mma3": 3, "mma6": 6}
    occ = {f: pk.anyhit(rays, planes, f) for f in splits}
    ref = {f: pk.anyhit_ref(rays, planes, split=sp)
           for f, sp in splits.items()}
    # the twins run thousands of PyTorch kernels a call (a trace of them
    # loses its marks) for about a second: CUDA events, once
    ms_ref = {f: cuda_ms(lambda sp=sp: pk.anyhit_ref(rays, planes, split=sp),
                         1, warmup=False) for f, sp in splits.items()}
    t = probe_ms({f: (lambda f=f: pk.anyhit(rays, planes, f))
                  for f in splits}
                 | {"matmul": lambda: prof_fma.dots_matmul(rays, planes)})
    mis = {f: float((occ[f] != ref[f]).float().mean()) for f in splits}
    mis["mma6 vs fma"] = float((occ["mma6"] != occ["fma"]).float().mean())
    print(f"probe any hit ({nr} rays x {planes.shape[0]} rows, occluded "
          f"{float(ref['fma'].float().mean()):.4f}): mismatch "
          + ", ".join(f"{k} {v:.2e}" for k, v in mis.items())
          + f"; mma3 vs fma (not gated) "
          f"{float((occ['mma3'] != occ['fma']).float().mean()):.2e}")
    if max(mis.values()) > prof_fma.GATE:
        fails.append(f"the any hit is over the primitive gate: {mis}")
    print(f"probe builds: anyhit_mma_kernel "
          f"{ptxas_report('prof/anyhit.cu', 'anyhit_mma_kernel')}, "
          f"gather_shared_kernel "
          f"{ptxas_report('prof/mem.cu', 'gather_shared_kernel')}")
    anyhit_sass_report(lambda: pk.anyhit(rays, planes, "mma3"),
                       nr * planes.shape[0])
    fma_sass_report(lambda: pk.anyhit(rays, planes, "fma"),
                    nr * planes.shape[0])
    pairs = nr * planes.shape[0]
    nbytes = 32 * nr + planes.numel() * 4 + nr
    for f in splits:
        mma = 0 if f == "fma" else FLOP_ANY_DOTS * splits[f]
        record[f"prof_anyhit_{f}"] = probe_record(
            t[f][0], ms_ref[f], nbytes,
            (FLOP_ANY_EPI + (FLOP_ANY_DOTS if f == "fma" else 0)) * pairs,
            t["matmul"][0], mis[f], tensor_flops=mma * pairs)
        events[f"prof_anyhit_{f}"] = t[f][1]

    rg = 1920 * 1088
    for k in (1024, 8192):  # the kernels line keeps K = 8192's
        table = torch.arange(k, dtype=torch.float32, device=dev) * 0.5
        idx = pk.gather_index(rg, k, dev)
        idx_l = idx.long()
        want = table.index_select(0, idx_l)
        tex = pk.texture(table)
        try:
            errs = {}
            for where in pk.GATHER_WHERE:
                got = pk.table_gather(table, idx, where, tex=tex)
                if not torch.equal(got, want):
                    fails.append(f"the {where} table gather differs at "
                                 f"K = {k}")
                errs[where] = max_err(got, want)
            # index and output cold in L2, as the bound assumes
            t = probe_ms({w: prof_gather.cold(
                lambda ix, w=w: pk.table_gather(table, ix, w, tex=tex), idx)
                for w in pk.GATHER_WHERE}
                | {"twin": prof_gather.cold(
                    lambda ix: table.index_select(0, ix.long()), idx),
                   "index_select": prof_gather.cold(
                       lambda ix: table.index_select(0, ix), idx_l)})
            print(f"probe table gather K = {k}: device ms "
                  + ", ".join(f"{w} {v[0]:.4f} (events {v[1]:.4f})"
                              for w, v in t.items()))
            if k != 8192:
                continue
            for where in pk.GATHER_WHERE:
                record[f"prof_table_gather_{where}"] = probe_record(
                    t[where][0], t["twin"][0], 8 * rg + 4 * k, 0.0,
                    t["index_select"][0], errs[where])
                events[f"prof_table_gather_{where}"] = t[where][1]
        finally:
            torch.cuda.synchronize()
            pk.free_texture(tex)
    cpack = prof_v3.pack(WIDTH * HEIGHT, dev)
    rc = cpack.shape[1]
    want = pk.chain_ref(cpack)
    ms_ref = probe_ms({"twin": lambda: pk.chain_ref(cpack)}, reps=1,
                      rounds=1)["twin"][0]
    laid = {c: pk.chain_inputs(cpack, c) for c in pk.CHAIN_LAYOUTS}
    t = probe_ms({c: (lambda c=c: pk.chain_laid(laid[c], c))
                  for c in pk.CHAIN_LAYOUTS})
    for layout in pk.CHAIN_LAYOUTS:
        got = pk.chain(cpack, layout)
        if not torch.equal(got, want):
            fails.append(f"the {layout} chain differs from its twin")
        # the function reads a, b, m (7 floats) and writes 3 a pixel in
        # every layout; float4's padding is not work it needs. Each of its
        # 90 x 3 x 2 operations takes a whole FP32 lane slot (2 flops at
        # PEAK_FLOPS, which counts an FFMA as two): the twin rounds the
        # product and the sum apart, so none contracts into an FFMA
        record[f"prof_chain_{layout}"] = probe_record(
            t[layout][0], ms_ref, (28 + 12) * rc, 90 * 3 * 2 * 2 * rc, None,
            max_err(got, want))
        events[f"prof_chain_{layout}"] = t[layout][1]
    chain_sass_report({c: (lambda c=c: pk.chain_laid(laid[c], c))
                       for c in pk.CHAIN_LAYOUTS}, rc)
    for name, ev in events.items():
        probe_line(name, record[name], ev)
    gate(fails, "probe kernels")
    stage_bounds(dev)

    # (b) the `full` builds of the stage probes' sources
    for frm in (pscenes.hall(dev), pscenes.headline(dev)):
        if not prof_gvariants.full_build_equal(frm):
            fails.append(f"b6_full differs on the {frm.name}")
    for frm in (pscenes.hall(dev), pscenes.hall(dev, sky=True)):
        calls = prof_vissplit.b7_calls(frm, dev, {"main": None,
                                                  "full": "b7_full"})
        if not torch.equal(calls["main"](), calls["full"]()):
            fails.append(f"b7_full differs on the {frm.name}")
    for frm in (pscenes.hall(dev), pscenes.headline(dev)):
        calls = prof_vissplit.b10_calls(frm, dev, {"main": None,
                                                   "full": "b10_full"})
        if not torch.equal(calls["main"](), calls["full"]()):
            fails.append(f"b10_full differs on the {frm.name}")
    gate(fails, "the stage probes' full builds")
    print("probe builds: b6_full, b7_full and b10_full write the main "
          "library's packs bit for bit (hall, sky hall, headline)")

    # (c) the slice's main path
    pk.reset_launches()
    t1 = time.perf_counter()
    if prof_main.main(["all"]) != 0:
        raise PhaseError("python -m restir_tpu_torch.prof all failed")
    torch.cuda.synchronize()
    print(f"main path restir_tpu_torch.prof all ({time.perf_counter() - t1:.1f}"
          f" s) launches {pk.launches}")
    for name, counter in PROBE_LAUNCHES.items():
        launches[name] = pk.launches[counter]
    idle = [n for n, c in PROBE_LAUNCHES.items() if not pk.launches[c]]
    if idle:
        raise PhaseError(f"probes: kernels not launched on the main path: "
                         f"{idle}")
    from restir_tpu_torch.prof import _timing
    print(f"phase 28 (probes): {time.perf_counter() - t0:.1f} s; device-time "
          f"traces retaken for lost marks: {_timing.retakes}")


def same_bits(what, a, b):
    """Gate: two builds' outputs equal bit for bit on every lane."""
    lanes = bits_equal(a, b).all(0)
    print(f"{what}: lanes equal bit for bit {float(lanes.float().mean()):.7f}"
          f" of {lanes.numel()}")
    if not bool(lanes.all()):
        raise PhaseError(f"{what}: {int((~lanes).sum())} lanes differ")


def b10_twin_gate(what, k10, r10, shade):
    """Phase 12's gates of B10 against its twin; returns the largest
    weight error on same-pick lanes."""
    li, wi_, w_ = ris_cdf.OUT_LI, ris_cdf.OUT_WI, ris_cdf.OUT_W
    pick = (torch.all(k10[li:li + 3] == r10[li:li + 3], 0)
            & torch.all(torch.isclose(k10[wi_:wi_ + 3], r10[wi_:wi_ + 3],
                                      rtol=2e-4, atol=1e-5), 0))
    pm = float(pick[shade].float().mean())
    ok = pick & shade
    wclose = float(torch.isclose(k10[w_][ok], r10[w_][ok], rtol=2e-4,
                                 atol=1e-7).float().mean())
    m_eq = float((k10[ris_cdf.OUT_M] == r10[ris_cdf.OUT_M]).float().mean())
    occ_eq = float(((k10[w_] == 0) == (r10[w_] == 0))[ok].float().mean())
    print(f"{what}: pick match {pm:.6f}, weights within rtol 2e-4 "
          f"{wclose:.6f}, M equal {m_eq:.6f}, occlusion equal on same-pick "
          f"lanes {occ_eq:.6f}, visible winners "
          f"{float((k10[w_][shade] > 0).float().mean()):.4f} on "
          f"{int(shade.sum())} shading lanes")
    if pm < 0.995 or wclose < 0.999 or m_eq < 0.9999:
        raise PhaseError(f"{what}: B10 disagrees with its twin")
    return float((k10[w_][ok] - r10[w_][ok]).abs().max())


def search_bound(t, r, k, rescan=0):
    """(least ms, what binds it) of the light search: the gb pack's
    channels it reads and the rs pack it writes, the light rows once;
    one light target a light row and k candidates, as walk_bound7 and
    ris_bound10 count them. `rescan`: light targets a pixel evaluates
    again on top (the design's own picks re-scan K x S rows)."""
    n_l = t.n_lights
    return bound(r * (13 + 8) * 4 + table_bytes(t.lights[:n_l], t.psi[:n_l]),
                 r * ((n_l + rescan) * FLOP_LIGHT + k * FLOP_CAND))


def search_against_twin(name, gb, t, bvh, pix, k, has_met, w, seg):
    """The light search kernel alone (B7's launch of it, `_parts=1`)
    against its twin on the sample pixels: the rs pack before visibility
    against `fused_di.ris_all` (its targets and cdf round as the kernels
    do: `fused_di.ris_targets`, `cdf_rows`), the same winner on every
    shading lane and its weight within rtol 2e-4; the picks of its CPU
    mirror (`reuse.ris_search`: `search_streamed`, checkpoints every S
    rows) equal to the twin's full row-order scan's on every lane, and
    the light targets each pixel evaluated equal to the mirror's.
    Returns the largest weight error on shading lanes."""
    before = reuse.search_launches
    rs, cnt = reuse.candidates_cuda(gb, 1, t, bvh, k=k, has_met=has_met,
                                    width=w, stats=True, _parts=1)
    if reuse.search_launches != before + 1:
        raise PhaseError(f"{name}: the search did not launch once")
    g = gb[:, pix]
    li, wi, _, wt = fused_di.ris_all(g, pix, 1, t, k=k, single_sided=True,
                                     has_met=has_met)
    idx_m, tq_m, total, ev = reuse.ris_search(g, pix, 1, t, k=k,
                                              single_sided=True, seg=seg)
    tt, _ = reuse.search_targets(g, t, single_sided=True)
    cdf = fused_di.cdf_rows(tt)
    last = cdf.shape[1] - 1
    idx_t = torch.stack([torch.clamp((cdf <= th[:, None]).sum(1), max=last)
                         for th in reuse.thresholds(pix, 1, k, cdf[:, last])])
    tq_t = torch.gather(tt, 1, idx_t.T).T
    same_picks = float(((idx_m == idx_t) & bits_equal(tq_m, tq_t)).all(0)
                       .float().mean())
    del tt, cdf
    rs = rs[:, pix]
    shade = g[fused_di.G_SHADE] > 0.5
    pick = (torch.all(rs[RS_LI:RS_LI + 3] == li, 0)
            & torch.all(torch.isclose(rs[RS_WI:RS_WI + 3], wi, rtol=2e-4,
                                      atol=1e-5), 0))
    pm = float(pick[shade].float().mean())
    wclose = float(torch.isclose(rs[RS_W][shade], wt[shade], rtol=2e-4,
                                 atol=1e-7).float().mean())
    w_bits = float(bits_equal(rs[RS_W][shade], wt[shade]).float().mean())
    same_ev = float((cnt[2][pix].long() == ev).float().mean())
    print(f"{name} search ris_search_kernel vs twin on {SAMPLE_TILES} tiles: "
          f"pick match {pm:.7f}, weights within rtol 2e-4 {wclose:.7f} "
          f"(bit for bit {w_bits:.7f}) on {int(shade.sum())} shading lanes; "
          f"the mirror's picks equal to the full scan's {same_picks:.7f}; "
          f"light targets equal to the mirror's {same_ev:.7f} (mean "
          f"{float(ev.double().mean()):.2f})")
    if pm < 1.0 or wclose < 1.0 or same_picks < 1.0 or same_ev < 1.0:
        raise PhaseError(f"{name}: the light search disagrees with its twin")
    return float((rs[RS_W][shade] - wt[shade]).abs().max())


def many_light_kernels(name, arrays, camkw, dev, record=None):
    """(a) and (b): B7 + B1b, the light search and B10 against their
    twins on one scene of many lights, with times and bounds."""
    scene = convert.scene_from_numpy(arrays, dev)
    t, bvh = scene.tables, scene.bvh
    n_l = t.n_lights
    cfg = render_config(arrays)
    w, h, r, k = cfg.width, cfg.height, cfg.num_pixels, cfg.cdf_candidates
    seg = reuse.seg_cuda(n_l, False, dev)
    print(f"{name}: {scene.num_tris} triangles, {n_l} light rows (l_pad "
          f"{t.psi.shape[0]}); the search of B7 and B10: checkpoints every "
          f"{seg} rows, {reuse.smem_bytes(n_l, False, n_l, seg)} and "
          f"{ris_cdf.smem_bytes(n_l)} B of shared memory a block")
    cam = make_camera(**camkw)
    pos = camkw["position"]
    cam2 = make_camera(**{**camkw, "position": (pos[0] + 0.25, pos[1],
                                                pos[2])})
    cv, cv2 = pack_camera(cam, dev), pack_camera(cam2, dev)
    gkw = dict(width=w, height=h, aa_jitter=cfg.aa_jitter,
               single_sided=cfg.single_sided_lights)
    rkw = dict(k=k, single_sided=cfg.single_sided_lights, temporal=True,
               temporal_clamp=cfg.temporal_clamp,
               has_met=cfg.scene_has_metallic)
    gb0 = gbuffer.gbuffer_cuda(cv, cv, 0, bvh, **gkw)
    pt0 = reuse.reuse_cuda(gb0, torch.zeros((PT_CH, r), device=dev), 0, t,
                           bvh, width=w, **rkw)
    gb_k = gbuffer.gbuffer_cuda(cv2, cv, 1, bvh, **gkw)
    before = reuse.launches, reuse.search_launches
    rs_k, cnt7 = reuse.candidates_cuda(gb_k, 1, t, bvh, k=k,
                                       has_met=rkw["has_met"], width=w,
                                       stats=True)
    if (reuse.launches, reuse.search_launches) != (before[0] + 1,
                                                    before[1] + 1):
        raise PhaseError(f"{name}: B7 did not launch its search and walk "
                         "once each")
    pt_k = fused_di.temporal_cuda(gb_k, rs_k, pt0, 1, k=k,
                                  temporal_clamp=rkw["temporal_clamp"])
    pix = sample_pixels(r, dev)
    pt_r = reuse.reuse_ref(gb_k[:, pix], pt0, 1, t, pix=pix, **rkw)
    torch.cuda.synchronize()
    fails, st7 = parity.pt_report(pt_r, pt_k[:, pix])
    print(f"{name} B7 reuse_bvh + B1b vs twin on {SAMPLE_TILES} tiles: "
          f"{json.dumps(st7)}")
    gate(fails, f"{name}: B7 disagrees with its twin")
    ev = cnt7[2]
    lo, hi = int(ev.min()), int(ev.max())
    print(f"{name} B7 light targets per pixel: mean "
          f"{float(ev.double().mean()):.2f}, min {lo}, max {hi} (bound "
          f"{n_l + k * seg}); shadow walk "
          f"{float(cnt7[0].double().mean()):.2f} box + "
          f"{float(cnt7[1].double().mean()):.2f} plane tests per ray")
    if lo < n_l or hi > n_l + k * seg:
        raise PhaseError(f"{name}: B7 evaluated {lo}-{hi} light targets")
    def b7():
        return reuse.candidates_cuda(gb_k, 1, t, bvh, k=k,
                                     has_met=rkw["has_met"], width=w)

    ms7 = cuda_ms(b7, 10)
    b7b = walk_bound7(t, bvh, r, k, cnt7, False)
    err_s = search_against_twin(name, gb_k, t, bvh, pix, k, rkw["has_met"],
                                w, seg)
    ms_s = device_ms(b7, 10, "ris_search_kernel")
    ms_w = device_ms(b7, 10, "reuse_walk_kernel")
    bs = search_bound(t, r, k)
    bs_rescan = search_bound(t, r, k, rescan=k * seg)

    pack, shade = b10_input(scene, cam, dev)
    kw = dict(k=k, single_sided=cfg.single_sided_lights,
              has_met=cfg.scene_has_metallic)
    before = ris_cdf.launches
    k10 = ris_cdf.ris_cdf_cuda(pack, 1, t, bvh, **kw)
    if ris_cdf.launches != before + 1:
        raise PhaseError(f"{name}: B10 did not launch once")
    kc10, c10 = ris_cdf.ris_cdf_cuda(pack, 1, t, bvh, stats=True, **kw)
    same_bits(f"{name} B10 counting build", kc10, k10)
    def b10():
        return ris_cdf.ris_cdf_cuda(pack, 1, t, bvh, **kw)

    ms10 = cuda_ms(b10, 10)
    ms10_s = device_ms(b10, 10, "ris_search_kernel")
    ms10_w = device_ms(b10, 10, "ris_cdf_kernel")
    p0, n = (h // 2) * w, 16 * w  # a band of 16 rows mid-frame
    r10 = ris_cdf.ris_cdf_ref(pack[:, p0:p0 + n], 1, t, pix0=p0, **kw)
    err10 = b10_twin_gate(f"{name} B10 ris_cdf vs twin on rows "
                          f"{h // 2}-{h // 2 + 15}", k10[:, p0:p0 + n], r10,
                          shade[p0:p0 + n])
    boxes, tests = walk_line(f"{name} B10 shadow", c10, c10[0] > 0)
    walk_tables = table_bytes(t.planes[:scene.num_tris], bvh.rows)
    b10 = ris_bound10(t, r, k, boxes, tests, walk_tables)
    print(f"{name} B7 reuse_bvh: kernel {ms7:.4f} ms (device: "
          f"search {ms_s:.4f} + walk {ms_w:.4f}), bound {b7b[0]:.4f} ms "
          f"({b7b[1]}); B10 ris_cdf: kernel {ms10:.4f} ms (device: search "
          f"{ms10_s:.4f} + walk {ms10_w:.4f}), bound {b10[0]:.4f} ms "
          f"({b10[1]}); the search ris_search_kernel: bound {bs[0]:.4f} ms "
          f"({bs[1]}: one target a light row), {bs_rescan[0]:.4f} ms with "
          f"the picks' re-scan of K x S = {k * seg} targets a pixel")
    if record is not None:
        ms7_ref = cuda_ms(lambda: reuse.reuse_ref(gb_k, pt0, 1, t, **rkw), 1,
                          warmup=False)
        ms10_ref = cuda_ms(lambda: ris_cdf.ris_cdf_ref(pack, 1, t, **kw), 1,
                           warmup=False)
        pix_all = torch.arange(r, device=dev)
        ms_s_ref = cuda_ms(lambda: fused_di.ris_all(
            gb_k, pix_all, 1, t, k=k, single_sided=True,
            has_met=rkw["has_met"]), 1, warmup=False)
        print(f"{name} twins over the frame: B7 + B1b {ms7_ref:.1f} ms, B10 "
              f"{ms10_ref:.1f} ms, the search (ris_all) {ms_s_ref:.1f} ms")
        record["ris_search"] = dict(
            max_abs_err=err_s, ms=ms_s, plain_ms=ms_s_ref, bound_ms=bs[0],
            bound_by=bs[1], library_ms=None)
    return scene, cfg, cam


def phase_many_lights(dev, record, launches):
    """Phase 29: B7 and B10 on light tables past what a block could stage
    whole. The search's launches in the kernels line are those of the
    fused main path on the 2,450-row scene, whose search it times."""
    levels = 5
    fused = {"gbuffer_bvh": 1, "reuse_bvh": 1, "ris_search": 1,
             "temporal": 1, "spatial": 1, "atrous_eaw": levels}
    general = {"primary_hit": 1, "ris_cdf": 1, "ris_search": 1,
               "atrous_eaw": levels}
    for n_quads, full in ((1225, True), (5000, False)):
        arrays, camkw = many_light_scene(n_quads, 24)
        name = f"many lights {2 * n_quads}"
        scene, cfg, cam = many_light_kernels(name, arrays, camkw, dev,
                                             record if full else None)
        frames = {} if full else dict(warmup=2, timed=4)
        counts = phase_main(name, scene, cfg, cam, dev, fused, **frames)
        if full:
            launches["ris_search"] = counts["ris_search"]
            profile_frames(name, scene, cfg, cam, dev)
        gcfg = cfg.replace(ris_mode="cdf")
        warm, timed = ((GENERAL_WARMUP, GENERAL_TIMED) if full else (2, 4))
        counts = phase_general_main(f"{name} general DI cdf + EAW", scene,
                                    gcfg, cam, dev, general, warm, timed,
                                    with_scene=False)
        if full:
            profile_frames(f"{name} general DI cdf + EAW", scene, gcfg, cam,
                           dev, with_scene=False)
            phase_quality_gate(dev, arrays, camkw)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_wall("1 device check")
    phase_build()
    phase_wall("2 build")

    arrays, camkw = many_light_scene(64, 24)
    cfg = render_config(arrays)
    cam = make_camera(**camkw)
    scene = convert.scene_from_numpy(arrays, dev)
    print(f"headline scene: {scene.num_tris} triangles, "
          f"{scene.tables.n_lights} light triangles")

    record, launches = {}, {}
    cv, cv2, pt0, gb_b1, pt_b1 = phase_kernels(scene, cfg, cam, dev, record)
    phase_wall("3 headline kernels")
    phase_mtbvh_headline(scene, cfg, dev, cv, cv2, pt0, gb_b1, pt_b1)
    phase_wall("4 MTBVH on the headline")
    phase_small_frames(arrays, cam, dev)
    phase_wall("5 small frames")
    levels = cfg.eaw_levels
    counts = phase_main("headline", scene, cfg, cam, dev, {
        "fused_di": 2, "spatial": 1, "atrous_eaw": levels})
    launches.update({k: counts[k] for k in ("fused_di", "spatial",
                                            "atrous_eaw")})
    profile_frames("headline", scene, cfg, cam, dev)
    phase_wall("6 headline main path")

    svgf_cfg = cfg.replace(denoiser=DenoiserType.SVGF)
    phase_svgf_kernels(svgf_cfg, gb_b1, dev, record)
    counts = phase_main("headline SVGF", scene, svgf_cfg, cam, dev, {
        "fused_di": 2, "spatial": 1, "svgf_temporal": 1,
        "svgf_variance": levels, "atrous_svgf": levels})
    launches.update({k: counts[k] for k in (
        "svgf_temporal", "svgf_variance", "atrous_svgf")})
    profile_frames("headline SVGF", scene, svgf_cfg, cam, dev)
    phase_wall("7 SVGF")

    env_arrays, env_kw = env_scene()
    launches["fused_di_env"] = phase_env_tex(
        "env", env_arrays, env_kw, dict(has_env=True), dev, record)
    tex_arrays, tex_kw = textured_scene(aux_maps=True)
    launches["fused_di_textures"] = phase_env_tex(
        "textures", tex_arrays, tex_kw, dict(with_textures=True), dev,
        record)
    phase_wall("8 env map and textures")

    hall_sf, hall_arrays, hall_cam = load_hall()
    hall_cfg = render_config(hall_arrays)
    hall = convert.scene_from_numpy(hall_arrays, dev)
    phase_hall_kernels(hall, hall_cfg, hall_cam, dev, record)
    phase_wall("9 hall kernels")
    counts = phase_main("hall", hall, hall_cfg, hall_cam, dev, {
        "gbuffer_bvh": 1, "reuse_bvh": 1, "ris_search": 1, "temporal": 1,
        "spatial": 1, "atrous_eaw": levels})
    launches.update(gbuffer_bvh=counts["gbuffer_bvh"],
                    reuse_bvh=counts["reuse_bvh"])
    profile_frames("hall", hall, hall_cfg, hall_cam, dev)
    phase_wall("10 hall main path")
    phase_sky_hall(hall_sf, hall_cam, dev)
    phase_wall("11 sky hall")
    phase_general(scene, cam, arrays, dev, record, launches)
    phase_wall("12-14 general path")
    phase_gi(scene, arrays, cam, dev, record, launches)
    phase_wall("15-18 ReSTIR GI")
    phase_walk(scene, cam, arrays, hall, hall_arrays, hall_cam, dev, record,
               launches)
    phase_wall("20-22 the MTBVH walk's main paths")
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(dev, tmp)
        phase_wall("23 CLI")
        phase_native_hall(dev, tmp)
        phase_wall("24 native builder and hall CLI")
        phase_viewer(scene, arrays, cam, dev, tmp)
        phase_wall("25 viewer")
    phase_bands(scene, cfg, cam, dev)
    phase_wall("26 fused row bands")
    phase_general_bands(scene, arrays, cam, dev)
    phase_wall("27 general row bands")
    phase_probes(dev, record, launches)
    phase_wall("28 probes")
    phase_many_lights(dev, record, launches)
    phase_wall("29 many lights")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **record[name]}
        for name in SOURCES
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
