"""The port never imports JAX or the JAX package, and its entry points
run on the card unless the caller asks for the CPU.

A fresh interpreter imports every module of restir_tpu_torch and
chip_smoke, renders one 128x8 RESTIR_DI + EAW frame on the CPU through
the public entry points, loads scenes/cornell.txt with the port's loader,
renders a frame of a procedural scene over 1024 triangles (the MTBVH
path's twins) and frames of the general path (PT_DIRECT, PT_FULL, general
ReSTIR DI), runs the CLI (`app.main`) for 2 frames of the Cornell box at
32x32, and reports which modules got loaded (every module of the
package, `app`, `viewer` and `native` among them, is imported first).
"""

import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys
import numpy as np
import chip_smoke  # the on-card driver imports the same way
import restir_tpu_torch
for m in pkgutil.walk_packages(restir_tpu_torch.__path__, "restir_tpu_torch."):
    importlib.import_module(m.name)
from restir_tpu_torch import convert, renderer
from restir_tpu_torch.config import DenoiserType, RenderConfig, mat_flags
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.scene.procedural import many_light_scene

arrays, camkw = many_light_scene(4, 2)
scene = convert.scene_from_numpy(arrays, "cpu")
cfg = RenderConfig(width=128, height=8, denoiser=DenoiserType.EAW,
                   **mat_flags(arrays))
cam = make_camera(**camkw)
state = renderer.init_state(cfg, cam, scene, device="cpu")
state, frame = renderer.step(scene, state, cam, cfg)
img = renderer.frame_to_image(frame, cfg)

from restir_tpu_torch.scene.loader import parse_scene_file
cornell = parse_scene_file("scenes/cornell.txt")
c_arrays = cornell.build()
c_scene = convert.scene_from_numpy(c_arrays, "cpu")
big, big_kw = many_light_scene(4, 90)
big_scene = convert.scene_from_numpy(big, "cpu")
assert big_scene.num_tris > 1024, big_scene.num_tris
big_cfg = RenderConfig(width=128, height=8, denoiser=DenoiserType.EAW,
                       **mat_flags(big))
big_cam = make_camera(**big_kw)
big_state = renderer.init_state(big_cfg, big_cam, big_scene, device="cpu")
big_state, big_frame = renderer.step(big_scene, big_state, big_cam, big_cfg)
from restir_tpu_torch.config import TracerType
general = {}
for tracer in (TracerType.PT_DIRECT, TracerType.PT_FULL, TracerType.RESTIR_DI):
    g_cfg = RenderConfig(width=32, height=8, tracer=tracer, trace_depth=2,
                         **mat_flags(arrays))
    g_state = renderer.init_state(g_cfg, cam, device="cpu")
    g_state, g_frame = renderer.step(scene, g_state, cam, g_cfg)
    general[str(tracer)] = [type(g_state).__name__,
                            bool(np.isfinite(g_frame.numpy()).all())]
import os, tempfile
from restir_tpu_torch import app
with tempfile.TemporaryDirectory() as tmp:
    app_rc = app.main(["--builtin", "cornell", "--width", "32", "--height",
                       "32", "--frames", "2", "-o",
                       os.path.join(tmp, "cli.png")], device="cpu")
    app_png = sorted(os.listdir(tmp))
print(json.dumps({
    "app": [app_rc, app_png],
    "general": general,
    "cornell_tris": c_scene.num_tris,
    "big_finite": bool(np.isfinite(big_frame.numpy()).all()),
    "big_mean": float(big_frame.mean()),
    "modules": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax.")
                      or m == "jaxlib" or m.startswith("jaxlib.")
                      or m == "restir_tpu" or m.startswith("restir_tpu.")),
    "shape": list(img.shape),
    "finite": bool(np.isfinite(frame.numpy()).all()),
}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["modules"] == [], rep["modules"]
    assert rep["shape"] == [8, 128, 3]
    assert rep["finite"]
    assert rep["cornell_tris"] == 36
    assert rep["big_finite"] and rep["big_mean"] > 0.0
    assert rep["general"] == {str(t): ["RenderState", True]
                              for t in (1, 2, 0)}
    assert rep["app"] == [0, ["cli.png"]]


def test_entry_points_default_to_the_card():
    """No public function of the port defaults its `device` to the CPU: a
    caller gets the CPU only by asking for it."""
    import restir_tpu_torch

    sys.path.insert(0, REPO)
    cpu_defaults = []
    for m in pkgutil.walk_packages(restir_tpu_torch.__path__,
                                   "restir_tpu_torch."):
        mod = importlib.import_module(m.name)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__ or name.startswith("_"):
                continue
            dev = inspect.signature(fn).parameters.get("device")
            if dev is not None and str(dev.default) == "cpu":
                cpu_defaults.append(f"{m.name}.{name}")
    assert cpu_defaults == []
