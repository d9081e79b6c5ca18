"""The port's CLI (`restir_tpu_torch.app`) against the JAX package's
(`restir_tpu.app`), both on the CPU.

- the argument parsers hold the same flags, choices and defaults;
- `--builtin cornell --tracer pt_direct` at 32x32, 3 frames, still and
  with `--animate-radius 0.5`: the PFMs agree within
  `test_torch_general.py`'s gate (rtol 1e-4 on >= 99.5 % of pixels);
- a checkpoint written by either CLI after 2 frames resumes in the other
  for a third, which agrees with 3 frames of the JAX CLI the same way;
- PNG, PFM, HDR and JPEG outputs read back as the same image;
- `--rmse-vs-pt` and `--profile` print their keys, and `--debug-nans`
  raises FloatingPointError naming the frame that went NaN;
- `python -m restir_tpu_torch` without a card exits non-zero with a clear
  message and renders nothing;
- the camera helpers the CLI animates with equal JAX's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from restir_tpu import app as japp
from restir_tpu.ops import camera as jcam
from restir_tpu_torch import app as tapp
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.ops import camera as tcam
from restir_tpu_torch.utils.image_io import read_hdr, read_pfm, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--builtin", "cornell", "--tracer", "pt_direct", "--width", "32",
        "--height", "32"]


def _close_px(want, got, frac=0.995, rtol=1e-4, atol=1e-6):
    """test_torch_general.py's gate on [H, W, 3] images."""
    assert want.shape == got.shape == (32, 32, 3)
    assert np.isfinite(got).all()
    ok = np.isclose(want, got, rtol=rtol, atol=atol).all(-1).mean()
    assert ok >= frac, ok


def _spec(parser):
    return sorted(
        (a.dest, tuple(a.option_strings), a.default,
         tuple(a.choices) if a.choices else None, a.nargs, a.type, a.metavar,
         type(a).__name__)
        for a in parser._actions)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_argparser_matches_jax():
    assert _spec(tapp.build_argparser()) == _spec(japp.build_argparser())


@pytest.mark.parametrize("animate", [[], ["--animate-radius", "0.5"]],
                         ids=["still", "animated"])
def test_pt_direct_matches_jax_cli(tmp_path, capsys, animate):
    args = BASE + ["--frames", "3", "--stats-json"] + animate
    assert japp.main(args + ["-o", str(tmp_path / "j.pfm")]) == 0
    want = _last_json(capsys)
    assert tapp.main(args + ["-o", str(tmp_path / "t.pfm")],
                     device="cpu") == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["frames"] == 3 and got["resolution"] == [32, 32]
    ref = read_pfm(str(tmp_path / "j.pfm"))
    img = read_pfm(str(tmp_path / "t.pfm"))
    assert ref.mean() > 0.0
    _close_px(ref, img)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_resumes_across_clis(tmp_path, capsys, saver):
    mains = {"jax": japp.main,
             "torch": lambda a: tapp.main(a, device="cpu")}
    loader = "torch" if saver == "jax" else "jax"
    ck = str(tmp_path / "state.npz")
    assert japp.main(BASE + ["--frames", "3", "-o",
                             str(tmp_path / "ref.pfm")]) == 0
    assert mains[saver](BASE + ["--frames", "2", "--save-state", ck, "-o",
                                str(tmp_path / "a.pfm")]) == 0
    assert mains[loader](BASE + ["--frames", "1", "--load-state", ck, "-o",
                                 str(tmp_path / "b.pfm")]) == 0
    capsys.readouterr()
    ref = read_pfm(str(tmp_path / "ref.pfm"))
    first = read_pfm(str(tmp_path / "a.pfm"))
    resumed = read_pfm(str(tmp_path / "b.pfm"))
    _close_px(ref, resumed)
    # the third frame moved the running mean: the state was carried over
    assert not np.allclose(first, resumed)


def test_outputs_read_back(tmp_path, capsys):
    PIL = pytest.importorskip("PIL.Image")
    args = BASE + ["--frames", "2"]
    out = {}
    for ext in ("png", "pfm", "hdr", "jpg"):
        path = str(tmp_path / f"x.{ext}")
        assert tapp.main(args + ["-o", path], device="cpu") == 0
        assert path in capsys.readouterr().out
        out[ext] = path
    png = read_png(out["png"])
    pfm = read_pfm(out["pfm"])
    hdr = read_hdr(out["hdr"])
    jpg = np.asarray(PIL.open(out["jpg"]).convert("RGB"))
    assert png.shape == pfm.shape == hdr.shape == jpg.shape == (32, 32, 3)
    assert png.mean() > 0 and pfm.mean() > 0
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    big = pfm.max(-1, keepdims=True)
    assert np.all(np.abs(hdr - pfm) <= big / 64 + 1e-6)
    # the same frame, tonemapped, is the PNG (and the JPEG, lossily)
    from restir_tpu_torch.config import RenderConfig
    from restir_tpu_torch.utils.image_io import mirror_for_save

    cfg = RenderConfig(width=32, height=32)
    frame = torch.from_numpy(mirror_for_save(pfm).reshape(-1, 3).copy())
    tone = trenderer.frame_to_image(frame, cfg).numpy()
    assert np.array_equal(mirror_for_save(tone), png)
    assert np.abs(jpg.astype(int) - png).mean() < 8


def test_rmse_vs_pt_and_profile(tmp_path, capsys):
    assert tapp.main(BASE + ["--tracer", "restir_di", "--frames", "2",
                             "--rmse-vs-pt", "2", "--profile",
                             "--stats-json", "-o",
                             str(tmp_path / "x.png")], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    prof, stats = json.loads(lines[-2]), json.loads(lines[-1])
    assert set(prof) == {"gbuffer_ms", "frame_ms"}
    assert set(stats) == {"fps", "mrays_per_s", "compile_s", "frames",
                          "resolution", "output", "rmse_vs_pt"}
    assert np.isfinite(stats["rmse_vs_pt"]) and stats["rmse_vs_pt"] >= 0.0


def test_debug_nans_names_the_frame(tmp_path, monkeypatch):
    step = trenderer.step

    def poisoned(scene, state, cam, cfg):
        state, frame = step(scene, state, cam, cfg)
        if state.iteration == 2:
            frame = frame.clone()
            frame[5, 1] = float("nan")
        return state, frame

    args = BASE + ["--frames", "3", "-o", str(tmp_path / "x.png")]
    monkeypatch.setattr(trenderer, "step", poisoned)
    assert tapp.main(args, device="cpu") == 0  # unchecked without the flag
    with pytest.raises(FloatingPointError, match="frame 1 "):
        tapp.main(args + ["--debug-nans"], device="cpu")


def test_module_entry_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "restir_tpu_torch", "--builtin", "cornell",
         "--frames", "1"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert os.listdir(tmp_path) == []  # no render.png


def test_camera_helpers_match_jax():
    kw = dict(position=(0.0, 4.5, 15.0), rotation=(-90.0, -10.0, 0.0),
              fov_y=30.0)
    jc, tc = jcam.make_camera(**kw), tcam.make_camera(**kw)
    base = np.asarray(jc.position)
    for t in (0.0, 0.1, 1.3, 7.7):
        jp = np.asarray(jcam.animate_position(base, np.float32(t), 0.5))
        tp = tcam.animate_position(base, np.float32(t), 0.5).numpy()
        np.testing.assert_allclose(tp, jp, rtol=1e-6)
        for rot in (None, (-80.0, 5.0, 0.0)):
            ju = jcam.as_numpy_camera(jcam.update_camera(jc, jp, rot))
            tu = tcam.as_numpy_camera(tcam.update_camera(tc, tp, rot))
            assert [type(x) for x in tu] == [np.ndarray] * len(tu)
            for a, b in zip(ju, tu):
                assert b.dtype == np.float32
                np.testing.assert_allclose(b, a, rtol=1e-6)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 32, 256).astype(np.float32)
    y = rng.integers(0, 16, 256).astype(np.float32)
    dist = rng.uniform(0.5, 20.0, 256).astype(np.float32)
    want = np.asarray(jax.jit(jcam.position_from_depth, static_argnums=(1, 2))(
        jc, 32, 16, jnp.asarray(x), jnp.asarray(y), jnp.asarray(dist)))
    got = tcam.position_from_depth(tc, 32, 16, torch.from_numpy(x),
                                   torch.from_numpy(y),
                                   torch.from_numpy(dist)).numpy()
    # rtol on each point's distance from the origin: the two packages'
    # ray directions may differ in the last bit, which a coordinate near
    # zero (o + d * dist cancelling) magnifies
    err = np.linalg.norm(got - want, axis=-1)
    assert np.all(err <= 1e-6 * np.linalg.norm(want, axis=-1))
