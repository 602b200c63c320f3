"""Multi-device hierarchical mesh generation.

Refinement and extraction are per-voxel independent, so the field shards
over the mesh's devices with **zero communication in the hot path**: each
chip refines and compacts its own voxel slice (the blocked compaction of
``ops.refine`` runs shard-locally), keeps its own live count, and extracts
its own triangles; the only global steps are the tiny per-level count
gather (host-side, to size the next level's static buffers — the same sync
the single-device pipeline already pays) and the final host weld.

Load balance: the initial dense grid is dealt round-robin (row ``d`` of the
grid goes to shard ``d % n``) so every chip sees a representative slice of
the surface — the voxel analogue of the sharded renderer's block striping.

The reference is single-GPU (src/cuda/mod.rs:52); this is the multi-device
scaling story for the mesh pipeline (SURVEY §2.4).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsdmg_tpu.config import MeshGenConfig
from bsdmg_tpu.mesh.field import VoxelField, _round_capacity, create_voxel_field
from bsdmg_tpu.mesh.pipeline import Mesh as TriMesh, triangles_to_mesh
from bsdmg_tpu.ops.marching_cubes import TriangleSoup, extract_triangles
from bsdmg_tpu.ops.refine import _BLOCK_ROWS, refine_step_blocked

SdfFn = Callable[[jax.Array], jax.Array]


class ShardedField:
    """A voxel field held as per-device compacted slices.

    ``lowers`` is a ``(n_shards * local_cap, 3)`` row-sharded device array;
    ``counts[d]`` is shard ``d``'s live-row count (host ints). Unlike the
    single-device :class:`VoxelField`, live rows are compacted *per shard*,
    not globally — downstream stages consume per-shard counts."""

    def __init__(self, lowers, counts, voxel_size, level=0):
        self.lowers = lowers
        self.counts = np.asarray(counts, np.int64)
        self.voxel_size = float(voxel_size)
        self.level = int(level)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def local_capacity(self) -> int:
        return self.lowers.shape[0] // len(self.counts)

    def gather(self) -> VoxelField:
        """Collect all shards into a host-compacted single-device
        :class:`VoxelField` (for checkpointing with ``mesh.export.save_field``
        or any single-device consumer)."""
        n = len(self.counts)
        buf = np.asarray(self.lowers).reshape(n, -1, 3)
        live = np.concatenate([buf[d, : self.counts[d]] for d in range(n)])
        cap = _round_capacity(max(int(live.shape[0]), 1))
        out = np.full((cap, 3), 1e6, np.float32)
        out[: live.shape[0]] = live
        return VoxelField(
            lowers=jnp.asarray(out),
            count=int(live.shape[0]),
            voxel_size=self.voxel_size,
            level=self.level,
        )


def distribute_field(
    field: VoxelField, mesh: Mesh
) -> ShardedField:
    """Deal a field's live voxels round-robin onto the mesh devices."""
    n = mesh.devices.size
    axes = tuple(mesh.axis_names)
    live = np.asarray(field.live_lowers())
    shards = [live[d::n] for d in range(n)]
    counts = [s.shape[0] for s in shards]
    local_cap = _round_capacity(max(counts))
    buf = np.full((n, local_cap, 3), 1e6, np.float32)
    for d, s in enumerate(shards):
        buf[d, : s.shape[0]] = s
    sharding = NamedSharding(mesh, P(axes, None))
    lowers = jax.device_put(buf.reshape(n * local_cap, 3), sharding)
    return ShardedField(lowers, counts, field.voxel_size, field.level)


@partial(jax.jit, static_argnames=("mesh", "new_cap"))
def _shrink_sharded_jit(mesh, new_cap, lowers):
    """Slice (or pad) every shard's local buffer to ``new_cap`` rows."""
    axes = tuple(mesh.axis_names)

    def local(lo):
        cur = lo.shape[0]
        if cur >= new_cap:
            return lo[:new_cap]
        pad = jnp.full((new_cap - cur, 3), 1e6, lo.dtype)
        return jnp.concatenate([lo, pad], axis=0)

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(axes, None), out_specs=P(axes, None),
        check_vma=False,
    )(lowers)


@partial(jax.jit, static_argnames=("mesh", "sdf", "csdf", "block_cap"))
def _refine_sharded_jit(mesh, sdf, csdf, block_cap, lowers, counts, voxel_size):
    axes = tuple(mesh.axis_names)

    def local(lo, cnt, size):
        out, c, _, alive = refine_step_blocked(
            sdf, lo, cnt[0], size, block_cap=block_cap, csdf=csdf
        )
        return out, c[None], alive[None]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axes, None), P(axes), P()),
        out_specs=(P(axes, None), P(axes), P(axes)),
        check_vma=False,
    )(lowers, counts, voxel_size)


def refine_field_sharded(
    sdf: SdfFn,
    sfield: ShardedField,
    config: MeshGenConfig,
    mesh: Mesh,
    csdf=None,
) -> ShardedField:
    """One refinement level, shard-local compaction, no collectives.

    Mirrors ``mesh.field.refine_field``'s block_cap guess + overflow retry,
    applied to the worst shard."""
    local_cap = sfield.local_capacity
    nb = (8 * local_cap) // _BLOCK_ROWS
    block_cap = max(64, -(-nb // 4))
    size = jnp.float32(sfield.voxel_size)
    counts_dev = jnp.asarray(sfield.counts, jnp.int32)
    while True:
        out, cnts, alive = _refine_sharded_jit(
            mesh, sdf, csdf, block_cap, sfield.lowers, counts_dev, size
        )
        counts = np.asarray(cnts)
        worst = int(np.asarray(alive).max())
        if worst <= block_cap or block_cap >= nb:
            break
        block_cap = min(nb, max(2 * block_cap, -(-worst * 9 // 8)))
    # shrink each shard's inflated output to the worst shard's rounded live
    # count — the same rule as the single-device refine_field: survivors are
    # O(surface area), and without this the per-level ~2x capacity compounds
    # so later levels sort/march exponentially many dead padding rows
    n_shards = mesh.devices.size
    out_local = out.shape[0] // n_shards
    new_cap = _round_capacity(int(counts.max()))
    if new_cap != out_local:
        out = _shrink_sharded_jit(mesh, new_cap, out)
    return ShardedField(
        out, counts, sfield.voxel_size / 2.0, sfield.level + 1
    )


def extract_sharded(
    sdf: SdfFn,
    sfield: ShardedField,
    config: MeshGenConfig,
    mesh: Mesh,
    csdf=None,
) -> TriangleSoup:
    """Shard-local marching cubes; returns the concatenated triangle soup
    (invalid/padding rows carry ``valid=False``, exactly like the
    single-device budget buffer). Edge-budget overflow on ANY shard (see
    mesh/pipeline.py::field_to_triangles) reruns all shards uncompacted."""
    import dataclasses

    import numpy as np

    pos, nrm, valid, overflow = _extract_sharded_jit(
        mesh, sdf, csdf, config, sfield.lowers,
        jnp.asarray(sfield.counts, jnp.int32), jnp.float32(sfield.voxel_size),
    )
    if config.edge_budget < 12 and int(np.max(np.asarray(overflow))) > 0:
        pos, nrm, valid, overflow = _extract_sharded_jit(
            mesh, sdf, csdf, dataclasses.replace(config, edge_budget=12),
            sfield.lowers, jnp.asarray(sfield.counts, jnp.int32),
            jnp.float32(sfield.voxel_size),
        )
    return TriangleSoup(pos, nrm, valid)


@partial(jax.jit, static_argnames=("mesh", "sdf", "csdf", "config"))
def _extract_sharded_jit(mesh, sdf, csdf, config, lowers, counts, voxel_size):
    axes = tuple(mesh.axis_names)

    def local(lo, cnt, size):
        soup = extract_triangles(sdf, lo, size, cnt[0], config, csdf)
        return (
            soup.positions, soup.normals, soup.valid,
            jnp.reshape(jnp.asarray(soup.edge_overflow, jnp.int32), (1,)),
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axes, None), P(axes), P()),
        out_specs=(
            P(axes, None, None, None),
            P(axes, None, None, None),
            P(axes, None),
            P(axes),
        ),
        check_vma=False,
    )(lowers, counts, voxel_size)


def generate_mesh_sharded(
    sdf: SdfFn,
    mesh: Mesh,
    refine_steps: int = 3,
    config: MeshGenConfig = MeshGenConfig(),
    csdf=None,
) -> TriMesh:
    """Full sharded pipeline: distribute -> refine^k (shard-local) ->
    extract (shard-local) -> host weld. Produces the same welded vertex set
    as the single-device ``generate_mesh`` (order may differ)."""
    sfield = distribute_field(create_voxel_field(config), mesh)
    for _ in range(refine_steps):
        sfield = refine_field_sharded(sdf, sfield, config, mesh, csdf=csdf)
    soup = extract_sharded(sdf, sfield, config, mesh, csdf=csdf)
    return triangles_to_mesh(soup, config)
