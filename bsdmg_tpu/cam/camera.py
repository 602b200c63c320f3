"""Pinhole camera and ray generation.

Reproduces the reference coordinate pipeline exactly
(cuda/modules/common.cu:15-88): texture pixel -> NDC -> camera plane -> world
ray, including the ``width_factor`` that reconciles the render-texture aspect
with the presented-window aspect, and the per-pixel *cone radius* used as a
depth-proportional collision threshold (common.cu:94-184).

All transforms are batched over pixel grids; the cone radius for
the full image is computed in one fused pass (4 corner rays per pixel) rather
than per-thread lambdas.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

SQRT_INV = 0.7071067811865475  # 1/sqrt(2), cuda/includes/utils.cu:14


class Camera(NamedTuple):
    """Camera basis, mirroring the reference ``CameraBuffer``
    (cuda/includes/bindings.h:23-29). All fields float32; vectors are unit."""

    position: jax.Array  # (3,)
    forward: jax.Array  # (3,)
    up: jax.Array  # (3,)
    right: jax.Array  # (3,)
    fov: jax.Array  # () vertical field of view in radians


def look_at(
    position,
    target=(0.0, 0.0, 0.0),
    world_up=(0.0, 1.0, 0.0),
    fov: float = math.pi / 4.0,
) -> Camera:
    """Build a camera looking from ``position`` at ``target``.

    Matches Bevy's ``Transform::looking_at`` basis (right-handed, forward is
    -Z of the transform, i.e. toward the target), which the reference feeds
    into its CameraBuffer (src/renderer/mod.rs:264-273, src/example_scene.rs:28-29).
    """
    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    world_up = jnp.asarray(world_up, jnp.float32)

    forward = target - position
    forward = forward / jnp.linalg.norm(forward)
    right = jnp.cross(forward, world_up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, forward)
    return Camera(position, forward, up, right, jnp.asarray(fov, jnp.float32))


def texture_to_ndc(p: jax.Array, texture_size) -> jax.Array:
    """Pixel center -> [0,1]^2 NDC (common.cu:15-17)."""
    return (p + 0.5) / jnp.asarray(texture_size, jnp.float32)


def ndc_to_camera(p: jax.Array, size) -> jax.Array:
    """NDC -> camera plane: x scaled by aspect, y flipped (common.cu:68-73)."""
    size = jnp.asarray(size, jnp.float32)
    aspect = size[0] / size[1]
    return jnp.stack(
        [(2.0 * p[..., 0] - 1.0) * aspect, 1.0 - 2.0 * p[..., 1]], axis=-1
    )


def camera_to_ray(p: jax.Array, camera: Camera, screen_size, texture_size) -> jax.Array:
    """Camera-plane point -> unit world ray direction (common.cu:75-88)."""
    screen = jnp.asarray(screen_size, jnp.float32)
    tex = jnp.asarray(texture_size, jnp.float32)
    width_factor = (screen[0] / tex[0]) * (tex[1] / screen[1])
    fov_fac = jnp.tan(camera.fov / 2.0)
    d = (
        camera.forward
        + p[..., 1:2] * fov_fac * camera.up
        + p[..., 0:1] * fov_fac * width_factor * camera.right
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def _pixel_to_dir(pix: jax.Array, camera: Camera, screen_size, texture_size) -> jax.Array:
    ndc = texture_to_ndc(pix, texture_size)
    cam = ndc_to_camera(ndc, texture_size)
    return camera_to_ray(cam, camera, screen_size, texture_size)


def pixel_cone_radius(
    pixel_coords: jax.Array, camera: Camera, screen_size, texture_size
) -> jax.Array:
    """Per-pixel cone radius at unit depth.

    The reference takes the max Euclidean distance between the center ray
    direction and 4 sub-pixel corner ray directions offset by ±1/sqrt(2) px
    (common.cu:94-184). Batched: corners stack on a new axis and reduce.
    """
    center = _pixel_to_dir(pixel_coords, camera, screen_size, texture_size)
    offsets = jnp.asarray(
        [
            [-SQRT_INV, -SQRT_INV],
            [-SQRT_INV, SQRT_INV],
            [SQRT_INV, -SQRT_INV],
            [SQRT_INV, SQRT_INV],
        ],
        jnp.float32,
    )
    corners = _pixel_to_dir(
        pixel_coords[..., None, :] + offsets, camera, screen_size, texture_size
    )  # (..., 4, 3)
    dist = jnp.linalg.norm(center[..., None, :] - corners, axis=-1)  # (..., 4)
    return jnp.max(dist, axis=-1)


def generate_rays(camera: Camera, texture_size, screen_size):
    """Full-image ray bundle.

    Returns ``(origins, directions, cone_radius)`` with shapes
    ``(H, W, 3), (H, W, 3), (H, W)``. Origins broadcast from the camera
    position; directions and cone radii follow the reference per-pixel math.
    """
    width, height = int(texture_size[0]), int(texture_size[1])
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    pix = jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), axis=-1)  # (H, W, 2)

    directions = _pixel_to_dir(pix, camera, screen_size, texture_size)
    cone = pixel_cone_radius(pix, camera, screen_size, texture_size)
    origins = jnp.broadcast_to(camera.position, directions.shape)
    return origins, directions, cone
