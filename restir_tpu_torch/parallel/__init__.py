"""Row-band rendering over a list of devices (the port of
`restir_tpu.parallel`): the general frame in bands (`shard_state`,
`make_sharded_step`) and the fused DI frame in bands
(`shard_fused_state`, `make_fused_sharded_step`), one band per mesh
entry."""

from .sharding import (  # noqa: F401
    PIXEL_AXIS,
    gather,
    gather_state,
    make_mesh,
    make_sharded_step,
    scene_to,
    shard_scene,
    shard_state,
)
from .fused_sharding import (  # noqa: F401
    make_fused_sharded_step,
    shard_fused_state,
)
