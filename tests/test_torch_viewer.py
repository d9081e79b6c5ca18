"""The port's browser viewer (`restir_tpu_torch.viewer`) on the CPU.

Mirrors `tests/test_viewer.py` (the page's controls, the settings
blackboard, the render loop publishing frames, here PNG), then one HTTP
round trip through `make_server` on 127.0.0.1 with port 0: `/`, `/stats`,
two `/stream` parts carrying PNGs, a `/ctl` settings change that builds
the render state anew (the iteration restarts), a camera move, and a
clean stop of both threads.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from restir_tpu_torch import convert, viewer
from restir_tpu_torch.config import (
    DenoiserType,
    RenderConfig,
    TracerType,
    mat_flags,
)
from restir_tpu_torch.ops.camera import make_camera
from restir_tpu_torch.scene.procedural import cornell_box
from restir_tpu_torch.utils.image_io import read_png

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def cornell():
    arrays, camkw = cornell_box()
    cfg = RenderConfig(width=16, height=16, tracer=TracerType.PT_DIRECT,
                       **mat_flags(arrays))
    return convert.scene_from_numpy(arrays, "cpu"), cfg, make_camera(**camkw)


def _wait(cond, what, timeout=120.0):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def test_page_served_controls():
    for control in ["tracer", "reuse", "denoiser", "tonemap", "/stream",
                    "/stats"]:
        assert control in viewer._PAGE


def test_viewer_state_camera_mutation():
    cfg = RenderConfig(width=16, height=16, tracer=TracerType.RESTIR_DI)
    cam = make_camera((0.0, 1.0, 5.0), (-90.0, 0.0, 0.0))
    vs = viewer.ViewerState(cfg, cam)
    assert not vs.cam_changed
    vs.rotation[0] += 3.0
    vs.cam_changed = True
    assert vs.position.shape == (3,)
    assert vs.cfg.width == 16
    viewer._control(vs, {"key": ["w"], "yaw": ["nan"], "pitch": ["1000"]})
    assert vs.rotation[1] == -89.0 and np.isfinite(vs.rotation).all()
    assert not np.allclose(vs.position, (0.0, 1.0, 5.0))
    viewer._control(vs, {"tracer": ["bogus"], "sig_depth": ["-1"]})
    assert not vs.cfg_changed and vs.cfg == cfg


def test_render_loop_produces_png(cornell):
    scene, cfg, cam = cornell
    vs = viewer.ViewerState(cfg, cam)
    t = threading.Thread(target=viewer._render_loop, args=(scene, vs, "cpu"))
    t.start()
    try:
        _wait(lambda: vs.frame_png or vs.error, "a frame")
    finally:
        vs.running = False
        t.join(60)
    assert not t.is_alive() and vs.error is None
    assert vs.frame_png.startswith(PNG_MAGIC)


def _read_part(resp):
    """One multipart/x-mixed-replace part -> (headers, body)."""
    line = resp.fp.readline()
    while line.strip() != b"--frame":
        line = resp.fp.readline()
    headers = {}
    while True:
        line = resp.fp.readline().strip()
        if not line:
            break
        k, v = line.decode().split(":", 1)
        headers[k.strip().lower()] = v.strip()
    body = resp.fp.read(int(headers["content-length"]))
    return headers, body


def test_http_round_trip(cornell, tmp_path):
    scene, cfg, cam = cornell
    server, state, render = viewer.make_server(scene, cfg, cam, port=0,
                                               device="cpu")
    host, port = server.server_address[:2]
    assert host == "127.0.0.1"
    serving = threading.Thread(target=server.serve_forever)
    serving.start()

    def get(path):
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, resp.getheader("Content-Type"), body

    def stats():
        return json.loads(get("/stats")[2])

    try:
        status, ctype, page = get("/")
        assert status == 200 and ctype == "text/html"
        assert b"/stream" in page
        assert get("/nope")[0] == 404
        _wait(lambda: stats()["iteration"] >= 3, "three frames")
        s = stats()
        assert (s["width"], s["height"]) == (16, 16) and s["fps"] > 0

        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert resp.getheader("Content-Type").startswith(
            "multipart/x-mixed-replace")
        frames = []
        for _ in range(2):
            headers, body = _read_part(resp)
            assert headers["content-type"] == "image/png"
            assert body.startswith(PNG_MAGIC)
            frames.append(body)
        conn.close()
        (tmp_path / "f.png").write_bytes(frames[-1])
        assert read_png(str(tmp_path / "f.png")).shape == (16, 16, 3)

        # a settings change builds the state anew; a move resets it
        for query, check in (
                ("denoiser=eaw",
                 lambda: state.cfg.denoiser == DenoiserType.EAW),
                ("key=w", lambda: not np.allclose(state.position,
                                                  cam.position.numpy()))):
            # far enough that the restart shows between two polls
            _wait(lambda: stats()["iteration"] >= 40, "40 frames")
            before = stats()["iteration"]
            assert get(f"/ctl?{query}")[0] == 204
            assert check()
            _wait(lambda: stats()["iteration"] < before,
                  f"the restart after {query}")
        assert state.error is None
    finally:
        server.shutdown()
        serving.join(30)
        viewer.stop(server, state, render)
    assert not serving.is_alive() and not render.is_alive()
