from bsdmg_tpu.parallel.mesh import (
    ShardedField,
    distribute_field,
    extract_sharded,
    generate_mesh_sharded,
    refine_field_sharded,
)
from bsdmg_tpu.parallel.sharding import (
    make_mesh,
    render_sharded,
    render_sharded_kernel,
    shard_rays,
    train_step,
)

__all__ = [
    "ShardedField",
    "distribute_field",
    "extract_sharded",
    "generate_mesh_sharded",
    "make_mesh",
    "refine_field_sharded",
    "render_sharded",
    "render_sharded_kernel",
    "shard_rays",
    "train_step",
]
