"""Scene text-file parser + OBJ / glTF mesh loaders.

A port of `restir_tpu.scene.loader` (numpy only): the same parser and
loaders, building the port's `SceneArrays` and `Camera`, so a scene file
loads into the port without the JAX package.

Parses the reference's custom line-token scene format
(the CUDA original's src/scene.cpp:96-131):

  Material <name>          6 lines: Type / BaseColor / Metallic /
                           Roughness / Ior / NormalMap; BaseColor,
                           Metallic, Roughness may name a texture file or
                           `Procedural` (scene.cpp:376-433)
  Object <name>            mesh file line, `Material <name|Null>` link,
                           then Translate/Rotate/Scale until a blank line
                           (scene.cpp:222-286)
  Camera                   8 fixed lines (Resolution/FovY/LensRadius/
                           FocalDist/ApertureMask/Sample/Depth/File) then
                           Eye/Rotation/Up until a blank line
                           (scene.cpp:288-355)
  EnvMap <file|Null>       (scene.cpp:122-128)

The OBJ loader is a from-scratch triangle-soup reader equivalent to the
reference's tiny_obj_loader usage (scene.cpp:23-55): triangulates faces
as fans, resolves negative indices, generates flat normals when absent.
Textures load as LINEAR float RGB (stbi_ldr_to_hdr_gamma(1.f),
scene.cpp:97) and are vertically flipped except env maps (scene.cpp:98,
122-126).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.camera import Camera, make_camera
from ..utils.image_io import read_hdr, read_pfm, read_png
from .mesh import (
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    PROCEDURAL_TEXTURE,
    MaterialDesc,
    MeshInstance,
)
from .scene_data import SceneArrays, build_scene

MATERIAL_TYPE_TOKENS = {
    "Lambertian": LAMBERTIAN,
    "MetallicWorkflow": METALLIC_WORKFLOW,
    "Dielectric": DIELECTRIC,
    "Light": LIGHT,
}


@dataclasses.dataclass
class SceneFile:
    """Everything a scene file describes, pre-build."""

    instances: List[MeshInstance]
    materials: List[MaterialDesc]
    textures: List[np.ndarray]
    env_map: Optional[np.ndarray]
    # camera block
    resolution: Tuple[int, int] = (800, 800)
    fov_y: float = 19.5
    lens_radius: float = 0.0
    focal_dist: float = 1.0
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    max_iterations: int = 0
    trace_depth: int = 5
    image_name: str = "render"

    def build(self, bvh_impl: str = "auto") -> SceneArrays:
        return build_scene(
            self.instances,
            self.materials,
            env_map=self.env_map,
            textures=self.textures if self.textures else None,
            bvh_impl=bvh_impl,
        )

    def make_camera(self) -> Camera:
        return make_camera(
            position=self.position,
            rotation=self.rotation,
            fov_y=self.fov_y,
            lens_radius=self.lens_radius,
            focal_dist=self.focal_dist,
        )


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OBJ → (vertices[3n,3], normals[3n,3], uvs[3n,2]) triangle soup."""
    positions: List[List[float]] = []
    normals: List[List[float]] = []
    uvs: List[List[float]] = []
    tri_idx: List[Tuple[int, int, int]] = []  # (pos, uv, norm), -1 = absent

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                corners = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vp = resolve(parts[0], len(positions))
                    vt = (
                        resolve(parts[1], len(uvs))
                        if len(parts) > 1 and parts[1]
                        else -1
                    )
                    vn = (
                        resolve(parts[2], len(normals))
                        if len(parts) > 2 and parts[2]
                        else -1
                    )
                    corners.append((vp, vt, vn))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri_idx.extend([corners[0], corners[k], corners[k + 1]])

    if not tri_idx:
        raise ValueError(f"no faces in OBJ file {path}")

    pos = np.asarray(positions, np.float32)
    nrm = np.asarray(normals, np.float32) if normals else np.zeros((0, 3), np.float32)
    tex = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)

    vi = np.asarray([t[0] for t in tri_idx])
    ti = np.asarray([t[1] for t in tri_idx])
    ni = np.asarray([t[2] for t in tri_idx])

    v = pos[vi]
    n = np.where(
        (ni >= 0)[:, None],
        nrm[np.maximum(ni, 0)] if nrm.size else np.zeros_like(v),
        0.0,
    ).astype(np.float32)
    uv = np.where(
        (ti >= 0)[:, None],
        tex[np.maximum(ti, 0)] if tex.size else np.zeros((len(ti), 2), np.float32),
        0.0,
    ).astype(np.float32)

    # flat normals where missing
    tris = v.reshape(-1, 3, 3)
    face_n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    face_n /= np.maximum(np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-20)
    missing = (np.linalg.norm(n.reshape(-1, 3, 3), axis=-1) < 1e-8)
    n = n.reshape(-1, 3, 3)
    n[missing] = np.repeat(face_n, 3, 0).reshape(-1, 3, 3)[missing]
    return v, n.reshape(-1, 3), uv


def load_gltf(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimal glTF 2.0 mesh loader -> (verts[3n,3], norms[3n,3], uvs[3n,2]).

    Reads .gltf (JSON + external .bin) and .glb containers; extracts
    POSITION/NORMAL/TEXCOORD_0 + indices of every triangle primitive,
    applying node transforms. The reference links tiny_gltf but its
    loadGLTFMesh is a stub with no body (scene.cpp:57-63) — this one
    actually works.
    """
    import base64
    import json as jsonlib
    import struct

    base_dir = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            data = f.read()
        magic, _version, _length = struct.unpack_from("<III", data, 0)
        if magic != 0x46546C67:
            raise ValueError("not a GLB file")
        off = 12
        gltf = None
        buffers_bin = None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                gltf = jsonlib.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                buffers_bin = chunk
            off += 8 + clen + (-clen % 4)
        buffers = [buffers_bin]
    else:
        with open(path) as f:
            gltf = jsonlib.load(f)
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf["uri"]
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base_dir, uri), "rb") as f:
                    buffers.append(f.read())

    comp_dtype = {5120: "i1", 5121: "u1", 5122: "<i2", 5123: "<u2",
                  5125: "<u4", 5126: "<f4"}
    type_count = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}

    def read_accessor(idx):
        """[count, ncomp] float64, through a strided view of the buffer
        (the same values the JAX loader unpacks element by element)."""
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view.get("buffer", 0)]
        n = acc["count"]
        ncomp = type_count[acc["type"]]
        dt = np.dtype(comp_dtype[acc["componentType"]])
        stride = view.get("byteStride") or ncomp * dt.itemsize
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        if n == 0:
            return np.zeros((0, ncomp), np.float64)
        need = start + (n - 1) * stride + ncomp * dt.itemsize
        if need > len(buf):
            raise ValueError(f"accessor {idx} reads past its buffer")
        arr = np.ndarray((n, ncomp), dt, buffer=buf, offset=start,
                         strides=(stride, dt.itemsize))
        return arr.astype(np.float64)

    def node_matrix(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m = m @ np.diag([*node["scale"], 1.0])
        if "rotation" in node:
            qx, qy, qz, qw = node["rotation"]
            rot = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ])
            rm = np.eye(4)
            rm[:3, :3] = rot
            m = rm @ m
        if "translation" in node:
            tm = np.eye(4)
            tm[:3, 3] = node["translation"]
            m = tm @ m
        return m

    all_v, all_n, all_uv = [], [], []

    def emit_mesh(mesh_idx, xform):
        normal_mat = np.linalg.inv(xform[:3, :3]).T
        for prim in gltf["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = read_accessor(attrs["POSITION"])
            nrm = read_accessor(attrs["NORMAL"]) if "NORMAL" in attrs else None
            uv = read_accessor(attrs["TEXCOORD_0"]) if "TEXCOORD_0" in attrs else None
            if "indices" in prim:
                idx = read_accessor(prim["indices"])[:, 0].astype(np.int64)
            else:
                idx = np.arange(pos.shape[0])
            v = pos[idx] @ xform[:3, :3].T + xform[:3, 3]
            all_v.append(v.astype(np.float32))
            if nrm is not None:
                n = nrm[idx] @ normal_mat.T
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            else:
                tris = v.reshape(-1, 3, 3)
                fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
                n = np.repeat(fn, 3, 0)
            all_n.append(n.astype(np.float32))
            all_uv.append(
                uv[idx].astype(np.float32) if uv is not None
                else np.zeros((len(idx), 2), np.float32)
            )

    def walk(node_idx, parent):
        node = gltf["nodes"][node_idx]
        m = parent @ node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], m)
        for child in node.get("children", []):
            walk(child, m)

    scene_idx = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_idx]["nodes"] if "scenes" in gltf else range(
        len(gltf.get("nodes", []))
    )
    for r in roots:
        walk(r, np.eye(4))
    if not all_v and "meshes" in gltf:  # mesh-only files without nodes
        for mi in range(len(gltf["meshes"])):
            emit_mesh(mi, np.eye(4))

    if not all_v:
        raise ValueError(f"no triangle primitives in {path}")
    return np.concatenate(all_v), np.concatenate(all_n), np.concatenate(all_uv)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dispatch by extension — Resource::loadModelMeshData (scene.cpp:65-72)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    return load_obj(path)


def _load_texture(path: str, flip: bool = True, srgb: bool = True
                  ) -> np.ndarray:
    """Linear float RGB [h, w, 3] — the role of stbi_loadf in
    Image::Image (image.cpp:14-29): any supported format decodes to
    linear float. HDR formats (.hdr Radiance RGBE, .pfm) are stored
    linear; LDR formats (PNG/JPG/...) are sRGB-encoded and get stb's
    gamma-2.2 linearization — except when srgb=False (data maps:
    normal/metallic/roughness, which are raw values, not colors)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        img = read_hdr(path)
        srgb = False
    elif ext == ".pfm":
        img = read_pfm(path)
        srgb = False
    elif ext == ".png":
        try:
            img = read_png(path).astype(np.float32) / 255.0
        except Exception:  # palette/16-bit/alpha PNGs: defer to PIL
            img = _load_texture_pil(path)
    else:  # JPG and anything else PIL can decode
        img = _load_texture_pil(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3].astype(np.float32)
    if srgb:
        img = img ** 2.2
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _load_texture_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ValueError(
            f"unsupported texture format (and PIL unavailable): {path}"
        ) from e
    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _is_number(tok: str) -> bool:
    """True when the token parses as a numeric literal (the reference's
    format allows either a number or a texture path here)."""
    try:
        float(tok)
        return True
    except (TypeError, ValueError):
        return False


def parse_scene_file(path: str) -> SceneFile:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        lines = [ln.rstrip("\r\n") for ln in f]

    sf = SceneFile(instances=[], materials=[], textures=[], env_map=None)
    material_map: Dict[str, int] = {}
    mesh_pool: Dict[str, tuple] = {}
    texture_map: Dict[str, int] = {}

    def resolve_path(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    def add_texture(p: str, flip: bool = True, srgb: bool = True) -> int:
        key = (p, flip, srgb)
        if key not in texture_map:
            texture_map[key] = len(sf.textures)
            sf.textures.append(
                _load_texture(resolve_path(p), flip=flip, srgb=srgb))
        return texture_map[key]

    i = 0

    def next_line():
        nonlocal i
        ln = lines[i] if i < len(lines) else ""
        i += 1
        return ln

    while i < len(lines):
        line = next_line()
        if not line.strip():
            continue
        tokens = line.split()

        if tokens[0] == "Material":
            mat = MaterialDesc()
            for _ in range(6):
                toks = next_line().split()
                if toks[0] == "Type":
                    mat.type = MATERIAL_TYPE_TOKENS[toks[1]]
                elif toks[0] == "BaseColor":
                    if len(toks) > 2:
                        mat.base_color = tuple(float(x) for x in toks[1:4])
                    elif toks[1] == "Procedural":
                        mat.base_map = PROCEDURAL_TEXTURE
                    else:
                        mat.base_map = add_texture(toks[1])
                elif toks[0] == "Metallic":
                    if _is_number(toks[1]):
                        mat.metallic = float(toks[1])
                    else:
                        mat.metallic_map = add_texture(toks[1], srgb=False)
                elif toks[0] == "Roughness":
                    if _is_number(toks[1]):
                        mat.roughness = float(toks[1])
                    else:
                        mat.roughness_map = add_texture(toks[1], srgb=False)
                elif toks[0] == "Ior":
                    mat.ior = float(toks[1])
                elif toks[0] == "NormalMap":
                    if toks[1] != "Null":
                        mat.normal_map = add_texture(toks[1], srgb=False)
            material_map[tokens[1]] = len(sf.materials)
            sf.materials.append(mat)

        elif tokens[0] == "Object":
            mesh_file = next_line().strip()
            key = mesh_file
            if key not in mesh_pool:
                mesh_pool[key] = load_mesh(resolve_path(mesh_file))
            v, n, uv = mesh_pool[key]

            mat_line = next_line().split()
            if mat_line[1] == "Null":
                mat_id = len(sf.materials)
                sf.materials.append(MaterialDesc())
            else:
                mat_id = material_map[mat_line[1]]

            translation, rotation, scale = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
            while True:
                ln = next_line()
                if not ln.strip():
                    break
                toks = ln.split()
                vals = tuple(float(x) for x in toks[1:4])
                if toks[0] == "Translate":
                    translation = vals
                elif toks[0] == "Rotate":
                    rotation = vals
                elif toks[0] == "Scale":
                    scale = vals
            sf.instances.append(
                MeshInstance(
                    vertices=v, normals=n, uvs=uv, material_id=mat_id,
                    translation=translation, rotation=rotation, scale=scale,
                )
            )

        elif tokens[0] == "Camera":
            for _ in range(8):
                toks = next_line().split()
                if toks[0] == "Resolution":
                    sf.resolution = (int(toks[1]), int(toks[2]))
                elif toks[0] == "FovY":
                    sf.fov_y = float(toks[1])
                elif toks[0] == "LensRadius":
                    sf.lens_radius = float(toks[1])
                elif toks[0] == "FocalDist":
                    sf.focal_dist = float(toks[1])
                elif toks[0] == "Sample":
                    sf.max_iterations = int(toks[1])
                elif toks[0] == "Depth":
                    sf.trace_depth = int(toks[1])
                elif toks[0] == "File":
                    sf.image_name = toks[1]
            while True:
                ln = next_line()
                if not ln.strip():
                    break
                toks = ln.split()
                vals = tuple(float(x) for x in toks[1:4])
                if toks[0] == "Eye":
                    sf.position = vals
                elif toks[0] == "Rotation":
                    sf.rotation = vals
                elif toks[0] == "Up":
                    sf.up = vals

        elif tokens[0] == "EnvMap":
            if tokens[1] != "Null":
                sf.env_map = _load_texture(resolve_path(tokens[1]), flip=False)

    return sf
