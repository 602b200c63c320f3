"""Multi-host initialization and voxel-block sharding.

Single code path for 1 host and N hosts: call :func:`initialize` once per
process, then build a global mesh with :func:`bsdmg_tpu.parallel.make_mesh`
— `jax.sharding` + jit handle cross-host collectives transparently.
(The reference has no multi-device story at all; src/cuda/mod.rs:52 pins
device 0.)
"""

from __future__ import annotations

import os
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed when running multi-host.

    No-ops in single-process mode (local devices or CPU testing). Reads the
    standard env vars if args are omitted.
    """
    coordinator = coordinator or os.environ.get("BSDMG_COORDINATOR")
    if coordinator is None:
        return
    # NOTE: `x or default` would misroute process 0 (falsy) to the env var
    if num_processes is None:
        num_processes = int(os.environ.get("BSDMG_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("BSDMG_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_voxels(lowers: jax.Array, mesh: Mesh, axis: str = "dp"):
    """Shard a padded voxel buffer over the mesh batch axis.

    Refinement and marching cubes are per-voxel independent, so a block
    sharding needs no communication; the prefix-sum compaction runs globally
    under jit (XLA turns the cumsum into a cross-device scan).
    """
    sharding = NamedSharding(mesh, P(axis))
    n = lowers.shape[0]
    shards = mesh.shape[axis]
    if n % shards != 0:
        pad = shards - (n % shards)
        lowers = jnp.concatenate(
            [lowers, jnp.full((pad, 3), 1e6, lowers.dtype)], axis=0
        )
    return jax.device_put(lowers, sharding)
