"""The port's scene loader builds the JAX package's scenes exactly.

`restir_tpu_torch.scene.loader` against `restir_tpu.scene.loader` on the
repo's scene files and meshes, on glTF / GLB files written here (node
transforms, indices, strides), and on a scene file with a texture and an
env map (which the port loads and renders). Every SceneArrays
leaf and the camera must be equal: scene ids, the BVH and the Morton
order all reach the kernels.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from restir_tpu.scene import loader as jloader
from restir_tpu_torch import config as tconfig
from restir_tpu_torch import convert
from restir_tpu_torch import renderer as trenderer
from restir_tpu_torch.scene import loader as tloader
from restir_tpu_torch.scene.scene_data import SceneArrays
from restir_tpu_torch.utils.image_io import write_pfm, write_png

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


@pytest.fixture(scope="module")
def cornell():
    path = os.path.join(SCENES, "cornell.txt")
    jsf = jloader.parse_scene_file(path)
    tsf = tloader.parse_scene_file(path)
    return jsf, jsf.build(bvh_impl="numpy"), tsf, tsf.build()


@pytest.mark.parametrize("field", SceneArrays._fields)
def test_cornell_leaves_equal(cornell, field):
    _, js, _, ts = cornell
    want = np.asarray(getattr(js, field))
    got = getattr(ts, field)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_cornell_camera_and_file_fields(cornell):
    jsf, _, tsf, _ = cornell
    for name in ("resolution", "fov_y", "lens_radius", "focal_dist",
                 "position", "rotation", "up", "max_iterations",
                 "trace_depth", "image_name"):
        assert getattr(tsf, name) == getattr(jsf, name), name
    jc, tc = jsf.make_camera(), tsf.make_camera()
    for name, a, b in zip(tc._fields, jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("mesh", ["cube.obj", "quad.obj"])
def test_obj_meshes_equal(mesh):
    path = os.path.join(SCENES, mesh)
    for want, got in zip(jloader.load_mesh(path), tloader.load_mesh(path)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _gltf_doc(bin_len, node, stride=None):
    view0 = {"buffer": 0, "byteOffset": 0, "byteLength": 48}
    if stride:
        view0 = {"buffer": 0, "byteOffset": 0, "byteLength": 96,
                 "byteStride": stride}
    return {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [node, {"mesh": 0, "translation": [0.0, 0.0, -2.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            view0,
            {"buffer": 0, "byteOffset": 96, "byteLength": 48},
            {"buffer": 0, "byteOffset": 144, "byteLength": 32},
            {"buffer": 0, "byteOffset": 176, "byteLength": 12},
        ],
        "buffers": [{"byteLength": bin_len}],
    }


def _gltf_bin(strided):
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(4, 3)).astype(np.float32)
    if strided:  # 24-byte stride: each position followed by 12 junk bytes
        pos_b = np.concatenate(
            [pos, rng.normal(size=(4, 3)).astype(np.float32)], 1).tobytes()
    else:
        pos_b = pos.tobytes() + bytes(48)
    nrm = rng.normal(size=(4, 3)).astype(np.float32)
    uv = rng.random((4, 2)).astype(np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    data = pos_b + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    return data + bytes(-len(data) % 4)


NODES = {
    "trs": {"mesh": 0, "children": [1], "translation": [1.0, 2.0, 3.0],
            "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
            "scale": [2.0, 1.0, 0.5]},
    "matrix": {"mesh": 0, "children": [1],
               "matrix": [0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1, 0,
                          0.5, 0.0, -1.0, 1]},
}


@pytest.mark.parametrize("node", sorted(NODES))
@pytest.mark.parametrize("container", ["gltf", "glb", "strided"])
def test_gltf_and_glb_equal(tmp_path, node, container):
    data = _gltf_bin(container == "strided")
    doc = _gltf_doc(len(data), NODES[node],
                    stride=24 if container == "strided" else None)
    if container == "glb":
        path = tmp_path / "mesh.glb"
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2,
                                28 + len(js) + len(data)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(data), 0x004E4942) + data)
    else:
        (tmp_path / "mesh.bin").write_bytes(data)
        doc["buffers"][0]["uri"] = "mesh.bin"
        path = tmp_path / "mesh.gltf"
        path.write_text(json.dumps(doc))
    want = jloader.load_mesh(str(path))
    got = tloader.load_mesh(str(path))
    assert got[0].shape == (12, 3)  # two nodes x two triangles
    for a, b in zip(want, got):
        assert b.dtype == a.dtype and np.array_equal(b, a)


SCENE_TXT = """Material lamp
Type Light
BaseColor 10 10 10
Metallic 0
Roughness 1
Ior 1.5
NormalMap Null

Material wall
Type Lambertian
BaseColor tex.png
Metallic 0
Roughness 1
Ior 1.5
NormalMap Null

Camera
Resolution 256 64
FovY 30
LensRadius 0
FocalDist 1
ApertureMask Null
Sample 4
Depth 3
File t
Eye 0 0 4
Rotation -90 0 0
Up 0 1 0

Object box
{cube}
Material wall
Scale 3 3 3

Object lamp
{quad}
Material lamp
Translate 0 1.4 0

EnvMap sky.pfm
"""


def test_textured_env_scene_loads_but_does_not_render(tmp_path):
    rng = np.random.default_rng(3)
    write_png(str(tmp_path / "tex.png"),
              rng.integers(0, 255, (8, 4, 3), dtype=np.uint8))
    write_pfm(str(tmp_path / "sky.pfm"),
              rng.random((4, 8, 3)).astype(np.float32))
    path = tmp_path / "scene.txt"
    path.write_text(SCENE_TXT.format(cube=os.path.join(SCENES, "cube.obj"),
                                     quad=os.path.join(SCENES, "quad.obj")))
    js = jloader.parse_scene_file(str(path)).build(bvh_impl="numpy")
    tsf = tloader.parse_scene_file(str(path))
    ts = tsf.build()
    for field in SceneArrays._fields:
        want = np.asarray(getattr(js, field))
        got = getattr(ts, field)
        assert got.shape == want.shape and np.array_equal(got, want), field
    scene = convert.scene_from_numpy(ts, "cpu")
    assert scene.has_env_map and scene.has_textures
    cam = tsf.make_camera()
    assert isinstance(cam.position, torch.Tensor)
    # the env / texture branches are ported: the scene renders now, and
    # a frame without the env map's flag is refused for a scene without one
    cfg = tconfig.RenderConfig(width=256, height=64, has_env_map=True,
                               with_textures=True, **tconfig.mat_flags(ts))
    state = trenderer.init_state(cfg, cam, scene, device="cpu")
    state, frame = trenderer.step(scene, state, cam, cfg)
    assert tuple(frame.shape) == (3, 256 * 64)
    assert bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.0
    plain = convert.scene_from_numpy(
        ts._replace(env_map=np.zeros((1, 1, 3), np.float32)), "cpu")
    with pytest.raises(ValueError, match="no env map"):
        trenderer.init_state(cfg, cam, plain, device="cpu")
