"""Fixed-capacity device containers: bitsets and bounded arrays.

JAX equivalents of the reference's device utilities
(cuda/includes/utils.cu:32-78): ``BitSet<N>`` (with a packed 32-bit word
backing, :34-58) and the fixed ``Array<T, N>`` / ``DynamicArray<T, N>``
(:70-78). Here these become immutable pytrees over dense arrays — the
same fixed-capacity + live-count pattern the compaction ops use
(bsdmg_tpu/ops/compact.py), exposed as reusable containers. The reference
never calls its versions from a kernel; ours are used by tests and available
to kernels as plain arrays.

Also includes the vector min/max reductions (cuda/includes/utils.cu:16-30),
which in JAX are one-liners kept here for parity and discoverability.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def vec_minimum(v: jax.Array) -> jax.Array:
    """min over the last (component) axis — utils.cu:16-22."""
    return jnp.min(v, axis=-1)


def vec_maximum(v: jax.Array) -> jax.Array:
    """max over the last (component) axis — utils.cu:24-30."""
    return jnp.max(v, axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BitSet:
    """Fixed-size bitset packed into uint32 words (utils.cu:32-58).

    Immutable: setters return a new BitSet. Usable inside jit; ``n`` is
    static (part of the pytree structure via the words array shape).
    """

    words: jax.Array  # (ceil(n/32),) uint32

    @staticmethod
    def zeros(n: int) -> "BitSet":
        return BitSet(jnp.zeros((max(1, -(-n // 32)),), jnp.uint32))

    @staticmethod
    def from_mask(mask: jax.Array) -> "BitSet":
        """Pack a boolean vector into words (little-endian bit order)."""
        n = mask.shape[0]
        pad = (-n) % 32
        m = jnp.pad(mask.astype(jnp.uint32), (0, pad)).reshape(-1, 32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        return BitSet(jnp.sum(m << shifts, axis=1, dtype=jnp.uint32))

    @property
    def capacity(self) -> int:
        return int(self.words.shape[0]) * 32

    def get(self, i) -> jax.Array:
        i = jnp.asarray(i, jnp.uint32)
        word = self.words[i // 32]
        return ((word >> (i % 32)) & 1).astype(jnp.bool_)

    def set(self, i, value=True) -> "BitSet":
        i = jnp.asarray(i, jnp.uint32)
        bit = jnp.uint32(1) << (i % 32)
        w = self.words[i // 32]
        new = jnp.where(jnp.asarray(value, bool), w | bit, w & ~bit)
        return BitSet(self.words.at[i // 32].set(new))

    def count(self) -> jax.Array:
        """Popcount over all words."""
        x = self.words
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return jnp.sum((x * 0x01010101) >> 24, dtype=jnp.uint32)

    def to_mask(self, n: int | None = None) -> jax.Array:
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bits = ((self.words[:, None] >> shifts) & 1).astype(bool).reshape(-1)
        return bits if n is None else bits[:n]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BoundedArray:
    """Fixed-capacity array + live count (utils.cu:70-78 DynamicArray).

    ``data`` has static shape (capacity, ...); ``count`` is a traced scalar.
    ``push`` appends without branching (out-of-capacity pushes drop, like
    the reference's unchecked ``add``).
    """

    data: jax.Array
    count: jax.Array  # int32 scalar

    @staticmethod
    def empty(capacity: int, item_shape=(), dtype=jnp.float32) -> "BoundedArray":
        return BoundedArray(
            jnp.zeros((capacity, *item_shape), dtype), jnp.int32(0)
        )

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def push(self, item) -> "BoundedArray":
        idx = jnp.minimum(self.count, self.capacity - 1)
        keep = self.count < self.capacity
        data = jax.lax.cond(
            keep,
            lambda d: d.at[idx].set(item),
            lambda d: d,
            self.data,
        )
        return BoundedArray(data, self.count + keep.astype(jnp.int32))

    def get(self, i) -> jax.Array:
        return self.data[i]

    def live_mask(self) -> jax.Array:
        return jnp.arange(self.capacity) < self.count
