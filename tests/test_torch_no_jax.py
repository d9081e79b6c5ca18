"""The port never imports JAX or the JAX package.

A fresh interpreter imports restir_tpu_torch and chip_smoke, renders one
128x8 RESTIR_DI + EAW frame on the CPU through the public entry points,
loads scenes/cornell.txt with the port's loader, renders a frame of a
procedural scene over 1024 triangles (the MTBVH path's twins), and
reports which modules got loaded.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import numpy as np
import chip_smoke  # the on-card driver imports the same way
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
print(json.dumps({
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
