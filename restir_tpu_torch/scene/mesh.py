"""Host-side scene description: materials, mesh instances, primitives.

Numpy only, with the same float32 arithmetic as `restir_tpu.scene`, so a
scene built here is the scene the JAX package builds from the same input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# material types (restir_tpu.scene.scene_data)
LAMBERTIAN = 0
METALLIC_WORKFLOW = 1
DIELECTRIC = 2
LIGHT = 4

NULL_TEXTURE = -1
PROCEDURAL_TEXTURE = -2


@dataclasses.dataclass
class MaterialDesc:
    type: int = LAMBERTIAN
    base_color: tuple = (0.9, 0.9, 0.9)
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    base_map: int = NULL_TEXTURE
    metallic_map: int = NULL_TEXTURE
    roughness_map: int = NULL_TEXTURE
    normal_map: int = NULL_TEXTURE


@dataclasses.dataclass
class MeshInstance:
    vertices: np.ndarray  # [3n, 3] object space
    normals: np.ndarray  # [3n, 3]
    uvs: np.ndarray  # [3n, 2]
    material_id: int = 0
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)  # degrees, XYZ order
    scale: tuple = (1.0, 1.0, 1.0)


def quad_mesh(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3; normal = (p1-p0) x (p3-p0)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    n = np.cross(p1 - p0, p3 - p0)
    n = n / max(np.linalg.norm(n), 1e-20)
    verts = np.stack([p0, p1, p2, p0, p2, p3])
    norms = np.tile(n, (6, 1)).astype(np.float32)
    uvs = np.array(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32
    )
    return verts, norms, uvs


def cube_mesh(half=0.5):
    """Axis-aligned cube centred at the origin, 12 tris, outward normals."""
    h = half
    faces = [
        ([-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]),  # +z
        ([h, -h, -h], [-h, -h, -h], [-h, h, -h], [h, h, -h]),  # -z
        ([h, -h, h], [h, -h, -h], [h, h, -h], [h, h, h]),  # +x
        ([-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]),  # -x
        ([-h, h, h], [h, h, h], [h, h, -h], [-h, h, -h]),  # +y
        ([-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]),  # -y
    ]
    vs, ns, ts = zip(*(quad_mesh(*f) for f in faces))
    return np.concatenate(vs), np.concatenate(ns), np.concatenate(ts)


def build_transformation_matrix(translation, rotation_deg, scale):
    """T * Rx * Ry * Rz * S (float64)."""

    def rot(axis, deg):
        c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return m

    t = np.eye(4)
    t[:3, 3] = translation
    s = np.diag([*scale, 1.0])
    return (t @ rot(0, rotation_deg[0]) @ rot(1, rotation_deg[1])
            @ rot(2, rotation_deg[2]) @ s)
