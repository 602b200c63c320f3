"""On-device stream compaction: mask -> stable key sort -> slice.

The reference writes INFINITY/NaN sentinels from the kernel and compacts on
the **CPU** with ``Vec::retain`` after a blocking D2H copy
(src/cuda/mod.rs:184-194, cuda/modules/compute_mesh_generation.cu:53-57).
Here everything stays on device: a stable ``lax.sort`` on a 0/1 keep-key —
survivors float to the front in original order — compacts without a
dynamic scatter. Only the scalar count ever needs to reach the host (to
size the next stage's static shapes). Whether cumsum + scatter compaction is
faster on a GPU is not measured (ROADMAP S3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sort_compact(columns, mask, capacity: int, fills):
    """Stable-sort ``columns`` (tuple of (N,) arrays) by the keep-mask.

    Returns columns of length ``capacity`` with kept entries first (original
    order), ``fills[i]`` elsewhere, plus the unclipped kept count.
    """
    n = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    key = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    sorted_ops = jax.lax.sort((key, *columns), num_keys=1, is_stable=True)
    cols = list(sorted_ops[1:])
    live = jnp.arange(n) < count
    cols = [
        jnp.where(live, c, jnp.asarray(f, c.dtype)) for c, f in zip(cols, fills)
    ]
    if capacity <= n:
        cols = [c[:capacity] for c in cols]
    else:
        cols = [
            jnp.concatenate(
                [c, jnp.full((capacity - n,), f, c.dtype)]
            )
            for c, f in zip(cols, fills)
        ]
    return cols, count


def compact(
    data: jax.Array, mask: jax.Array, capacity: int | None = None, fill=0
):
    """Gather ``data[mask]`` to the front of a fixed-capacity buffer.

    Args:
      data: ``(N, ...)`` rows.
      mask: ``(N,)`` boolean keep-mask.
      capacity: output row count (defaults to ``N``). Rows beyond the kept
        count are ``fill``; if more than ``capacity`` rows are kept, the
        overflow is dropped (callers should check ``count``).
      fill: fill value for unused rows.

    Returns:
      ``(out, count)`` — ``out`` has shape ``(capacity, ...)``; ``count`` is
      the int32 number of kept rows (clipped to capacity in ``out`` but not in
      the returned count, so overflow is detectable).
    """
    n = data.shape[0]
    if capacity is None:
        capacity = n
    if n == 0:
        out = jnp.full((capacity,) + data.shape[1:], fill, dtype=data.dtype)
        return out, jnp.int32(0)

    flat = data.reshape(n, -1)
    k = flat.shape[1]
    cols, count = _sort_compact(
        tuple(flat[:, j] for j in range(k)), mask, capacity, (fill,) * k
    )
    out = jnp.stack(cols, axis=-1).reshape((capacity,) + data.shape[1:])
    return out, count.astype(jnp.int32)


