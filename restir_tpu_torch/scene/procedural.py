"""Procedural scenes, drawn in the same order from the same
`np.random.default_rng(seed)` as `restir_tpu.scene.procedural`, so the
same arguments build the same scene. `bvh_impl` picks the BVH builder
(`scene.bvh.build_bvh`)."""

from __future__ import annotations

import numpy as np

from .mesh import (
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    PROCEDURAL_TEXTURE,
    MaterialDesc,
    MeshInstance,
    cube_mesh,
    quad_mesh,
)
from .scene_data import SceneArrays, build_scene


def many_light_scene(n_lights: int = 64, n_blocks: int = 24, seed: int = 0,
                     bvh_impl: str = "auto"):
    """Benchmark hall: a grid of coloured area lights on the ceiling and
    scattered blocks of mixed materials. Returns (SceneArrays,
    camera_kwargs)."""
    rng = np.random.default_rng(seed)
    E = 16.0  # half-extent of the hall
    H = 8.0

    materials = [
        MaterialDesc(type=LAMBERTIAN, base_color=(0.65, 0.65, 0.65)),  # floor
        MaterialDesc(type=LAMBERTIAN, base_color=(0.45, 0.45, 0.5)),  # walls
    ]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t,
                                      material_id=mid))

    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)  # floor
    add_quad([-E, H, -E], [E, H, -E], [E, H, E], [-E, H, E], 1)  # ceiling
    add_quad([-E, 0, -E], [E, 0, -E], [E, H, -E], [-E, H, -E], 1)  # back
    add_quad([-E, 0, E], [-E, 0, -E], [-E, H, -E], [-E, H, E], 1)  # left
    add_quad([E, 0, -E], [E, 0, E], [E, H, E], [E, H, -E], 1)  # right

    g = int(np.ceil(np.sqrt(n_lights)))
    count = 0
    for i in range(g):
        for j in range(g):
            if count >= n_lights:
                break
            cx = -E + (i + 0.5) * (2 * E / g)
            cz = -E + (j + 0.5) * (2 * E / g)
            s = 0.45
            color = rng.uniform(0.2, 1.0, 3)
            color = tuple((color / color.max()
                           * rng.uniform(8.0, 30.0)).tolist())
            materials.append(MaterialDesc(type=LIGHT, base_color=color))
            mid = len(materials) - 1
            y = H - 1e-2
            add_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                     [cx + s, y, cz + s], [cx - s, y, cz + s], mid)
            count += 1

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    for _ in range(n_blocks):
        kind = rng.integers(0, 3)
        if kind == 0:
            materials.append(MaterialDesc(
                type=LAMBERTIAN, base_color=tuple(rng.uniform(0.2, 0.9, 3))))
        elif kind == 1:
            materials.append(MaterialDesc(
                type=METALLIC_WORKFLOW,
                base_color=tuple(rng.uniform(0.5, 1.0, 3)),
                metallic=float(rng.uniform(0.5, 1.0)),
                roughness=float(rng.uniform(0.05, 0.6)),
            ))
        else:
            materials.append(MaterialDesc(type=DIELECTRIC, ior=1.5))
        mid = len(materials) - 1
        sx, sy, sz = rng.uniform(0.8, 3.0, 3)
        instances.append(MeshInstance(
            vertices=cube_v, normals=cube_n, uvs=cube_t, material_id=mid,
            translation=(float(rng.uniform(-E * 0.85, E * 0.85)), sy / 2,
                         float(rng.uniform(-E * 0.85, E * 0.85))),
            rotation=(0.0, float(rng.uniform(0, 360)), 0.0),
            scale=(float(sx), float(sy), float(sz)),
        ))

    scene: SceneArrays = build_scene(instances, materials,
                                     bvh_impl=bvh_impl)
    camera_kwargs = dict(
        position=(0.0, 4.5, 15.0),
        rotation=(-90.0, -10.0, 0.0),
        fov_y=30.0,
        focal_dist=1.0,
    )
    return scene, camera_kwargs


def cornell_box(light_radiance=(12.0, 12.0, 12.0), light_size=1.6,
                with_blocks=True, block_materials=("lambert", "lambert"),
                bvh_impl: str = "auto"):
    """Cornell box: 5.5-unit cube interior, an area light under the
    ceiling, two blocks ("lambert", "metal" or "glass"). Returns
    (SceneArrays, camera_kwargs); the camera looks down -z through the
    open front face."""
    W = 2.75  # half width
    H = 5.5  # height
    materials = [
        MaterialDesc(type=LAMBERTIAN, base_color=(0.725, 0.71, 0.68)),
        MaterialDesc(type=LAMBERTIAN, base_color=(0.63, 0.065, 0.05)),
        MaterialDesc(type=LAMBERTIAN, base_color=(0.14, 0.45, 0.091)),
        MaterialDesc(type=LIGHT, base_color=tuple(light_radiance)),
    ]

    def block_mat(kind):
        if kind == "metal":
            materials.append(MaterialDesc(
                type=METALLIC_WORKFLOW, base_color=(0.8, 0.8, 0.85),
                metallic=1.0, roughness=0.15))
        elif kind == "glass":
            materials.append(MaterialDesc(
                type=DIELECTRIC, base_color=(1.0, 1.0, 1.0), ior=1.5))
        else:
            materials.append(MaterialDesc(type=LAMBERTIAN,
                                          base_color=(0.725, 0.71, 0.68)))
        return len(materials) - 1

    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t,
                                      material_id=mid))

    add_quad([-W, 0, W], [W, 0, W], [W, 0, -W], [-W, 0, -W], 0)  # floor
    add_quad([-W, H, -W], [W, H, -W], [W, H, W], [-W, H, W], 0)  # ceiling
    add_quad([-W, 0, -W], [W, 0, -W], [W, H, -W], [-W, H, -W], 0)  # back
    add_quad([-W, 0, W], [-W, 0, -W], [-W, H, -W], [-W, H, W], 1)  # red
    add_quad([W, 0, -W], [W, 0, W], [W, H, W], [W, H, -W], 2)  # green
    s, y = light_size / 2, H - 1e-2  # the light, facing down
    add_quad([-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s], 3)

    if with_blocks:
        v, n, t = cube_mesh(0.5)
        m0 = block_mat(block_materials[0])
        instances.append(MeshInstance(
            vertices=v, normals=n, uvs=t, material_id=m0,
            translation=(-0.95, 1.65, -0.85), rotation=(0, 18, 0),
            scale=(1.65, 3.3, 1.65)))
        m1 = block_mat(block_materials[1])
        instances.append(MeshInstance(
            vertices=v, normals=n, uvs=t, material_id=m1,
            translation=(0.95, 0.82, 0.55), rotation=(0, -15, 0),
            scale=(1.65, 1.65, 1.65)))

    scene = build_scene(instances, materials, bvh_impl=bvh_impl)
    camera_kwargs = dict(position=(0.0, 2.75, 9.5),
                         rotation=(-90.0, 0.0, 0.0),  # view (0, 0, -1)
                         fov_y=19.5, focal_dist=1.0)
    return scene, camera_kwargs


def env_scene(n_blocks: int = 4, n_lights: int = 2, env_size=(64, 128),
              seed: int = 3, bvh_impl: str = "auto"):
    """Open scene under a smooth gradient sky: a floor, scattered blocks,
    a few area lights and an equirect env map. Returns (SceneArrays,
    camera_kwargs)."""
    rng = np.random.default_rng(seed)
    E = 8.0
    materials = [MaterialDesc(type=LAMBERTIAN, base_color=(0.6, 0.6, 0.6))]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t,
                                      material_id=mid))

    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)
    for i in range(n_lights):
        color = tuple((rng.uniform(0.3, 1.0, 3)
                       * rng.uniform(6.0, 15.0)).tolist())
        materials.append(MaterialDesc(type=LIGHT, base_color=color))
        mid = len(materials) - 1
        cx = float(rng.uniform(-E * 0.5, E * 0.5))
        cz = float(rng.uniform(-E * 0.5, E * 0.5))
        s, y = 0.4, 3.0 + i
        add_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                 [cx + s, y, cz + s], [cx - s, y, cz + s], mid)

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    for _ in range(n_blocks):
        materials.append(MaterialDesc(
            type=LAMBERTIAN, base_color=tuple(rng.uniform(0.2, 0.9, 3))))
        mid = len(materials) - 1
        sx, sy, sz = rng.uniform(0.6, 1.8, 3)
        instances.append(MeshInstance(
            vertices=cube_v, normals=cube_n, uvs=cube_t, material_id=mid,
            translation=(float(rng.uniform(-E * 0.6, E * 0.6)), sy / 2,
                         float(rng.uniform(-E * 0.6, E * 0.6))),
            rotation=(0.0, float(rng.uniform(0, 360)), 0.0),
            scale=(float(sx), float(sy), float(sz)),
        ))

    scene = build_scene(instances, materials, env_map=gradient_sky(*env_size),
                        bvh_impl=bvh_impl)
    camera_kwargs = dict(position=(0.0, 2.0, 9.0), rotation=(-90.0, -5.0, 0.0),
                         fov_y=35.0, focal_dist=1.0)
    return scene, camera_kwargs


def gradient_sky(eh: int, ew: int) -> np.ndarray:
    """[eh, ew, 3] equirect sky of `env_scene`: a bright warm band near
    the horizon and a cool zenith."""
    v = (np.arange(eh, dtype=np.float32) + 0.5) / eh
    u = (np.arange(ew, dtype=np.float32) + 0.5) / ew
    band = np.exp(-((v - 0.45) ** 2) / 0.02)[:, None]
    azim = 0.6 + 0.4 * np.sin(u * 2.0 * np.pi)[None, :]
    env = np.zeros((eh, ew, 3), np.float32)
    env[..., 0] = 1.2 * band * azim + 0.08
    env[..., 1] = 0.9 * band * azim + 0.12
    env[..., 2] = 0.5 * band * azim + 0.25
    return env


def textured_scene(seed: int = 5, bvh_impl: str = "auto",
                   aux_maps: bool = False):
    """Closed room with a base-colour-textured floor and back wall, a
    procedurally textured block and two area lights. `aux_maps` adds a
    metallic-workflow ceiling with metallic and roughness maps and a
    normal-mapped right wall. Returns (SceneArrays, camera_kwargs).
    `seed` draws nothing (the room is fixed); it keeps the JAX signature."""
    E, H = 6.0, 5.0

    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    tex0 = np.stack([0.2 + 0.7 * checker, 0.25 + 0.4 * checker,
                     np.full_like(checker, 0.35)], axis=-1)
    gy, gx = np.meshgrid(np.linspace(0, 1, 96), np.linspace(0, 1, 128),
                         indexing="ij")
    tex1 = np.stack([0.3 + 0.5 * gx, 0.3 + 0.5 * gy,
                     0.8 - 0.5 * gx * gy], axis=-1).astype(np.float32)

    textures = [tex0, tex1]
    ceil_mat = MaterialDesc(type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55))
    wall_mat = ceil_mat
    if aux_maps:
        # texture 2: metallic / roughness in channel 0 (stripes); texture
        # 3: a tangent-space normal map around (0.5, 0.5, 1.0)
        sy, sx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        stripes = ((sx // 8) % 2).astype(np.float32) * 0.8 + 0.1
        tex2 = np.stack([stripes, 0.3 + 0.0 * stripes,
                         0.7 + 0.0 * stripes], axis=-1)
        by, bx = np.meshgrid(np.linspace(0, 4 * np.pi, 64),
                             np.linspace(0, 4 * np.pi, 64), indexing="ij")
        nx = 0.3 * np.sin(bx)
        ny = 0.3 * np.sin(by)
        nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
        tex3 = np.stack([nx * 0.5 + 0.5, ny * 0.5 + 0.5,
                         nz * 0.5 + 0.5], axis=-1).astype(np.float32)
        textures += [tex2, tex3]
        ceil_mat = MaterialDesc(type=METALLIC_WORKFLOW,
                                base_color=(0.7, 0.65, 0.6),
                                metallic_map=2, roughness_map=2)
        wall_mat = MaterialDesc(type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55),
                                normal_map=3)
    materials = [
        MaterialDesc(type=LAMBERTIAN, base_map=0),  # textured floor
        MaterialDesc(type=LAMBERTIAN, base_map=1),  # textured back wall
        MaterialDesc(type=LAMBERTIAN, base_color=(0.5, 0.5, 0.55)),
        MaterialDesc(type=LAMBERTIAN, base_map=PROCEDURAL_TEXTURE),
        MaterialDesc(type=LIGHT, base_color=(14.0, 12.0, 10.0)),
        MaterialDesc(type=LIGHT, base_color=(6.0, 8.0, 12.0)),
        ceil_mat,  # 6: ceiling
        wall_mat,  # 7: right wall
    ]
    instances = []

    def add_quad(p0, p1, p2, p3, mid):
        v, n, t = quad_mesh(p0, p1, p2, p3)
        instances.append(MeshInstance(vertices=v, normals=n, uvs=t,
                                      material_id=mid))

    add_quad([-E, 0, E], [E, 0, E], [E, 0, -E], [-E, 0, -E], 0)  # floor
    add_quad([-E, 0, -E], [E, 0, -E], [E, H, -E], [-E, H, -E], 1)  # back
    add_quad([-E, H, -E], [E, H, -E], [E, H, E], [-E, H, E], 6)  # ceiling
    add_quad([-E, 0, E], [-E, 0, -E], [-E, H, -E], [-E, H, E], 2)  # left
    add_quad([E, 0, -E], [E, 0, E], [E, H, E], [E, H, -E], 7)  # right

    cube_v, cube_n, cube_t = cube_mesh(0.5)
    instances.append(MeshInstance(
        vertices=cube_v, normals=cube_n, uvs=cube_t, material_id=3,
        translation=(-1.5, 0.9, -1.0), rotation=(0.0, 25.0, 0.0),
        scale=(1.8, 1.8, 1.8)))

    for i, (cx, cz) in enumerate([(-2.0, 1.0), (2.5, -2.0)]):
        s, y = 0.5, H - 1e-2
        add_quad([cx - s, y, cz - s], [cx + s, y, cz - s],
                 [cx + s, y, cz + s], [cx - s, y, cz + s], 4 + i)

    scene = build_scene(instances, materials, textures=textures,
                        bvh_impl=bvh_impl)
    camera_kwargs = dict(position=(0.0, 2.5, 7.0), rotation=(-90.0, -8.0, 0.0),
                         fov_y=35.0, focal_dist=1.0)
    return scene, camera_kwargs
