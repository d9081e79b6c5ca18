"""Row-band rendering over a list of devices: the mesh and the scene.

The port of the parts of `restir_tpu.parallel.sharding` that the fused
row-band step (`fused_sharding`) uses. The JAX package is single-
controller: one process builds a 1-D `Mesh` over its devices and runs
the same body on each (`shard_map`), and the only cross-device traffic
is halo slices between neighbouring bands. Its counterpart here is one
Python process that holds one band per entry of an ordered device list
(the "mesh") and copies halo slices between the bands' devices
(`Tensor.to(device, non_blocking=True)`: a peer copy between two cards
of one host). No `torch.distributed` process group is involved, so the
code runs unchanged on one card with several bands, on the CPU, or on a
host with several cards. A mesh may name one device more than once.

The scene is read-only and every ray needs all of it, so it is
replicated: one copy per distinct device of the mesh (`shard_scene`).

Not ported here (ROADMAP A9b): `shard_state` and `make_sharded_step`,
the general pipeline's row bands, which the JAX package gets from XLA's
partitioning of `jax.jit` shardings and which the port needs as
band-aware pixel ranges in its general modules.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..ops.kernels.tables import LazyWalkTables
from ..scene.scene_data import SceneTensors

PIXEL_AXIS = "pixels"  # the JAX mesh's axis name: row bands of pixels


def make_mesh(devices: Sequence = None) -> List[torch.device]:
    """The ordered device list that row bands map onto, one band per
    entry. Defaults to every CUDA device; it never falls back to the
    CPU, which must be asked for by name (`make_mesh(["cpu"] * 2)`)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; name the devices to use, e.g. "
                "make_mesh(['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: the device list is empty")
    return mesh


def _to(x, device):
    """A scene leaf on `device`: tensors copied, NamedTuples of tables
    walked, the lazy walk tables rebuilt there on first use."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, LazyWalkTables):
        return LazyWalkTables(x._arrays, x._verts.to(device))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def scene_to(scene: SceneTensors, device) -> SceneTensors:
    """`scene` with every table on `device` (the scene itself if it is
    there already)."""
    device = torch.device(device)
    if scene.tri_xform.device == device:
        return scene
    return _to(scene, device)


def shard_scene(scene: SceneTensors,
                mesh: Sequence[torch.device]) -> Dict[torch.device,
                                                      SceneTensors]:
    """Replicate the read-only scene: one `SceneTensors` per distinct
    device of the mesh, keyed by the device."""
    out = {}
    for d in mesh:
        if d not in out:
            out[d] = scene_to(scene, d)
    return out


def scene_on(scenes, device) -> SceneTensors:
    """The replica of `scenes` (`shard_scene`'s mapping, or one
    `SceneTensors`) on `device`."""
    if isinstance(scenes, SceneTensors):
        if scenes.tri_xform.device != device:
            raise ValueError(f"the scene is on {scenes.tri_xform.device}, "
                             f"a band on {device}: pass shard_scene's "
                             f"replicas")
        return scenes
    if device not in scenes:
        raise ValueError(f"no scene replica on {device}")
    return scenes[device]

