"""Texture fetch + bicubic (Catmull-Rom) sampling.

JAX equivalents of the reference's texture helpers
(cuda/modules/common.cu:23-66): ``fetch_2d``/``index_2d`` (clamp-to-edge
texel access) and ``cubic_interpolate``/``ndc_to_interpolated_value``
(separable Catmull-Rom resampling of an NDC-addressed texture). The
reference compiles these into its modules but no kernel calls them; they are
provided here as first-class, ``vmap``/``grad``-compatible ops so resampled
render targets (e.g. upscaling a half-res render) work out of the box.

Conventions match the reference exactly: texel (x, y) lives at flat index
``x + y * width``; NDC coordinates map ``p * size - 0.5`` onto the texel
grid; out-of-range fetches clamp to the edge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def index_2d(p: jax.Array, size) -> jax.Array:
    """Flat index of integer texel coords ``p = (..., 2)``, clamp-to-edge.

    Mirrors cuda/modules/common.cu:33-35.
    """
    p = jnp.asarray(p)
    x = jnp.clip(p[..., 0], 0, size[0] - 1)
    y = jnp.clip(p[..., 1], 0, size[1] - 1)
    return x + y * size[0]


def fetch_2d(p: jax.Array, texture: jax.Array, size=None) -> jax.Array:
    """Clamp-to-edge texel fetch (cuda/modules/common.cu:23-30).

    ``texture`` may be flat ``(W*H, ...)`` with ``size=(W, H)`` — the
    reference's layout — or a 2-D ``(H, W, ...)`` array (size inferred).
    """
    p = jnp.asarray(p)
    if texture.ndim >= 2 and size is None:
        h, w = texture.shape[:2]
        x = jnp.clip(p[..., 0], 0, w - 1)
        y = jnp.clip(p[..., 1], 0, h - 1)
        return texture[y, x]
    if size is None:
        raise ValueError("flat texture requires an explicit size=(W, H)")
    return texture[index_2d(p, size)]


def cubic_interpolate(y0, y1, y2, y3, rx1):
    """Catmull-Rom cubic through 4 samples at parameter ``rx1`` in [0, 1].

    Bit-for-bit the reference's Horner form (cuda/modules/common.cu:38-44).
    """
    return y1 + 0.5 * rx1 * (
        y2 - y0
        + rx1 * (2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3 + rx1 * (3.0 * (y1 - y2) + y3 - y0))
    )


def ndc_to_interpolated_value(p: jax.Array, texture: jax.Array, size=None) -> jax.Array:
    """Bicubic sample of a texture at NDC coords ``p = (..., 2)`` in [0, 1].

    Separable Catmull-Rom over a 4x4 texel neighborhood with clamp-to-edge,
    matching cuda/modules/common.cu:47-66. Works on flat ``(W*H,)`` textures
    with ``size=(W, H)`` or 2-D ``(H, W)`` textures.
    """
    p = jnp.asarray(p, jnp.float32)
    fetch_size = size  # None routes fetch_2d to the 2-D-grid path
    if size is None:
        if texture.ndim < 2:
            raise ValueError("flat texture requires an explicit size=(W, H)")
        size = (texture.shape[1], texture.shape[0])

    t = p * jnp.asarray([float(size[0]), float(size[1])]) - 0.5
    tc = jnp.floor(t).astype(jnp.int32)
    fx = t[..., 0] - tc[..., 0].astype(jnp.float32)
    fy = t[..., 1] - tc[..., 1].astype(jnp.float32)

    def row(i):
        def tap(j):
            q = jnp.stack(
                [tc[..., 0] + (j - 1), tc[..., 1] + (i - 1)], axis=-1
            )
            return fetch_2d(q, texture, fetch_size)

        return cubic_interpolate(tap(0), tap(1), tap(2), tap(3), fx)

    return cubic_interpolate(row(0), row(1), row(2), row(3), fy)
