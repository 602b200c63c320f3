"""Hierarchical voxel-field refinement (prune + subdivide).

Reference kernel (cuda/modules/compute_mesh_generation.cu:12-62): each input
voxel splits into 2x2x2 children; a child survives iff its 8 corners disagree
on ``sdf(corner) <= 0`` (it straddles the surface). The reference evaluates
all 8 corners of all 8 children — 64 SDF evals per parent — and compacts on
the CPU.

Redesign:

* The 8 children of a parent share corners: the unique corner set is the
  parent's 3x3x3 lattice — **27 evals per parent instead of 64** (2.4x fewer),
  batched over all parents in one fused call.
* Survivor children are compacted **on device** (see ``ops.compact``); only
  the scalar count crosses to the host, to size the next level's buffers.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from bsdmg_tpu.ops.compact import compact
from bsdmg_tpu.sdf.normals import as_component

SdfFn = Callable[[jax.Array], jax.Array]

# (27, 3) lattice offsets in units of the child voxel size
_LATTICE = np.stack(
    np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), axis=-1
).reshape(27, 3)

# child (i, j, k) for the 8 children, in the reference's output order
# n_id = i * 4 + j * 2 + k (compute_mesh_generation.cu:51)
_CHILD_IJK = np.stack(
    np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij"), axis=-1
).reshape(8, 3)

# corner offsets within a child, reference corner bit order c = x | y<<1 | z<<2
# (compute_mesh_generation.cu:38-45: c&1 -> x upper, c&2 -> y upper, c&4 -> z)
_CORNER_BITS = np.stack(
    [(np.arange(8) >> b) & 1 for b in (0, 1, 2)], axis=-1
)  # (8, 3) in (x, y, z)

# lattice flat index for corner `c` of child `child`: (child_ijk + corner_xyz)
# as (i, j, k) indices into the 3x3x3 lattice laid out i-major.
_CHILD_CORNER_IDX = np.zeros((8, 8), dtype=np.int32)
for _child in range(8):
    i, j, k = _CHILD_IJK[_child]
    for _c in range(8):
        x, y, z = _CORNER_BITS[_c]
        _CHILD_CORNER_IDX[_child, _c] = (i + x) * 9 + (j + y) * 3 + (k + z)


def child_lowers(lowers: jax.Array, voxel_size) -> jax.Array:
    """Lower corners of the 8 children, shape ``(N, 8, 3)``, reference order."""
    child_size = jnp.asarray(voxel_size, jnp.float32) / 2.0
    offsets = jnp.asarray(_CHILD_IJK, jnp.float32) * child_size
    return lowers[:, None, :] + offsets[None, :, :]


def refine_masks(
    sdf: SdfFn, lowers: jax.Array, voxel_size, valid: jax.Array,
    csdf=None,
) -> jax.Array:
    """Border mask per child, shape ``(N, 8)``.

    A child is a border voxel iff its 8 corner occupancies disagree
    (compute_mesh_generation.cu:36-49). Corner signs come from the shared
    3x3x3 parent lattice (27 evals/parent). SDF evaluation runs in
    component (SoA) form — flat coordinate planes — through ``csdf`` when
    the scene provides one.
    """
    if csdf is None:
        csdf = as_component(sdf)
    child_size = jnp.asarray(voxel_size, jnp.float32) / 2.0
    lattice = jnp.asarray(_LATTICE, jnp.float32) * child_size  # (27, 3)
    n = lowers.shape[0]
    px = (lowers[:, 0:1] + lattice[None, :, 0]).reshape(-1)  # (N*27,)
    py = (lowers[:, 1:2] + lattice[None, :, 1]).reshape(-1)
    pz = (lowers[:, 2:3] + lattice[None, :, 2]).reshape(-1)
    inside = (csdf(px, py, pz) <= 0.0).reshape(n, 27)  # (N, 27)

    corner_idx = jnp.asarray(_CHILD_CORNER_IDX)  # (8, 8)
    child_corners = inside[:, corner_idx]  # (N, 8 children, 8 corners)
    border = jnp.any(child_corners != child_corners[..., :1], axis=-1)  # (N, 8)
    return border & valid[:, None]


#: Compaction granule of the packed fast path: 64 parents x 8 children —
#: small enough that ~20-50% of blocks staying alive still cuts the fine
#: sort 2-4x, big enough that the alive-block gather moves few, large rows.
_BLOCK_ROWS = 512


def refine_step_blocked(
    sdf: SdfFn,
    lowers: jax.Array,
    count: jax.Array,
    voxel_size,
    *,
    block_cap: int,
    capacity: int | None = None,
    csdf=None,
    origin: float | None = None,
):
    """One refinement level with two-stage blocked compaction.

    The generic one-stage sort compaction (``ops.compact``) moves all 8N
    candidate rows x 4 columns through the sort network even though only a
    few % survive. This production path exploits survivor *clustering*
    (children of compacted surface parents are contiguous):

    1. **Block stage**: any-survivor reduction over ``_BLOCK_ROWS``-row
       blocks, a tiny stable key sort over the ~nb block ids, and a gather
       of the first ``block_cap`` blocks — few large rows.
    2. **Fine stage**: the standard stable 4-column sort (keep-key, x, y, z)
       over the reduced ``block_cap * _BLOCK_ROWS`` rows — typically 4-8x
       fewer rows than 8N.

    Returns ``(out, new_count, new_voxel_size, alive_blocks)``; ``new_count``
    and ``alive_blocks`` are true (unclipped) counts so the caller can detect
    ``block_cap`` overflow — survivors beyond the gathered blocks are dropped
    from ``out`` — and retry with a larger cap (mesh/field.py does).
    """
    n = lowers.shape[0]
    total = 8 * n
    if total % _BLOCK_ROWS:
        raise ValueError(f"input capacity {n} not a multiple of {_BLOCK_ROWS // 8}")
    nb = total // _BLOCK_ROWS
    block_cap = min(block_cap, nb)
    rows = block_cap * _BLOCK_ROWS
    if capacity is None:
        capacity = rows

    valid = jnp.arange(n) < count
    safe = jnp.where(valid[:, None], lowers, 1e6)
    mask = refine_masks(sdf, safe, voxel_size, valid, csdf=csdf)  # (N, 8)

    bm = mask.reshape(nb, _BLOCK_ROWS)
    alive = jnp.any(bm, axis=1)
    alive_blocks = jnp.sum(alive.astype(jnp.int32))
    bkey = jnp.where(alive, jnp.int32(0), jnp.int32(1))
    _, sel = jax.lax.sort(
        (bkey, jnp.arange(nb, dtype=jnp.int32)), num_keys=1, is_stable=True
    )
    sel = sel[:block_cap]
    # child coordinates as separate planes (child_lowers stays points-API)
    child_off = jnp.asarray(_CHILD_IJK, jnp.float32) * (
        jnp.asarray(voxel_size, jnp.float32) / 2.0
    )
    cols = [
        (safe[:, a : a + 1] + child_off[None, :, a])
        .reshape(nb, _BLOCK_ROWS)[sel]
        .reshape(-1)
        for a in range(3)
    ]
    mk = bm[sel].reshape(-1)

    if origin is None:
        key = jnp.where(mk, jnp.int32(0), jnp.int32(1))
        _, sx, sy, sz = jax.lax.sort((key, *cols), num_keys=1, is_stable=True)
    else:
        # Packed fine sort: on a dyadic lattice
        # (bb_size with a short mantissa — field.py gates this) child lowers
        # are exactly ``origin + ijk * child_size`` with ijk < 2^11, so the
        # 4-column float sort collapses to a 2-column int32 sort (packed
        # (i,j) + dead flag as the key, k riding along; survivor ORDER is
        # irrelevant — callers treat the field as a set) and coordinates
        # are reconstructed from the lattice afterwards; sort cost scales
        # with the number of columns.
        child = jnp.asarray(voxel_size, jnp.float32) / 2.0
        inv = 1.0 / child

        def q(c):
            return jnp.round((c - origin) * inv).astype(jnp.int32)

        hi = jnp.where(mk, (q(cols[0]) << 11) | q(cols[1]), jnp.int32(1) << 30)
        lo = jnp.where(mk, q(cols[2]), 0)
        hi, lo = jax.lax.sort((hi, lo), num_keys=1, is_stable=False)
        sx = origin + ((hi >> 11) & 2047).astype(jnp.float32) * child
        sy = origin + (hi & 2047).astype(jnp.float32) * child
        sz = origin + lo.astype(jnp.float32) * child

    new_count = jnp.sum(mask.astype(jnp.int32))
    # on block_cap overflow some survivors were dropped by `sel`; mark only
    # the rows actually gathered as live (callers detect and retry anyway)
    live = jnp.arange(rows) < jnp.sum(mk.astype(jnp.int32))
    out = jnp.stack(
        [
            jnp.where(live, sx, 1e6),
            jnp.where(live, sy, 1e6),
            jnp.where(live, sz, 1e6),
        ],
        axis=-1,
    )
    if capacity <= rows:
        out = out[:capacity]
    else:
        out = jnp.concatenate(
            [out, jnp.full((capacity - rows, 3), 1e6, jnp.float32)]
        )
    return (
        out,
        new_count,
        jnp.asarray(voxel_size, jnp.float32) / 2.0,
        alive_blocks,
    )


def refine_step(
    sdf: SdfFn,
    lowers: jax.Array,
    count: jax.Array,
    voxel_size,
    capacity: int | None = None,
    csdf=None,
):
    """One refinement level on a padded voxel buffer.

    Args:
      sdf: scene SDF.
      lowers: ``(CAP_IN, 3)`` voxel lower corners (rows >= count are padding).
      count: int32 scalar of live voxels.
      voxel_size: scalar (cubic voxels, like the reference field).
      capacity: output buffer rows; defaults to ``8 * CAP_IN``.

    Returns:
      ``(child_lowers (capacity, 3), new_count, new_voxel_size)``.
    """
    n = lowers.shape[0]
    if capacity is None:
        capacity = 8 * n
    valid = jnp.arange(n) < count
    # keep padded rows far outside so their SDF is huge and they never border
    safe_lowers = jnp.where(valid[:, None], lowers, 1e6)

    mask = refine_masks(sdf, safe_lowers, voxel_size, valid, csdf=csdf)  # (N, 8)
    children = child_lowers(safe_lowers, voxel_size)  # (N, 8, 3)

    flat_children = children.reshape(-1, 3)
    flat_mask = mask.reshape(-1)
    out, new_count = compact(flat_children, flat_mask, capacity=capacity, fill=1e6)
    return out, new_count, jnp.asarray(voxel_size, jnp.float32) / 2.0
