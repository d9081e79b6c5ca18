"""Row-band rendering over a list of devices (the port of
`restir_tpu.parallel`): the fused DI frame in bands, one per mesh entry.
The general pipeline's `shard_state` / `make_sharded_step` are not ported
yet (ROADMAP A9b)."""

from .sharding import (  # noqa: F401
    PIXEL_AXIS,
    make_mesh,
    scene_to,
    shard_scene,
)
from .fused_sharding import (  # noqa: F401
    gather,
    make_fused_sharded_step,
    shard_fused_state,
)
