"""Shading: two-color Lambert mix, ACES filmic tonemap, RGBA8 conversion.

Reference: cuda/modules/compute_render.cu:67-96 (shading + store) and
cuda/includes/color.cu:7-22 (ACES matrices, Stephen Hill fit).
"""

from __future__ import annotations

from typing import Callable

import math

import jax
import jax.numpy as jnp

from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.ops.trace import COLLISION, STEP_LIMIT, RayMarchHit, march_planes
from bsdmg_tpu.sdf.normals import normal_fd4, normal_grad

# Collision gradient colors (compute_render.cu:73-76), in linear [0,1].
COLOR_LOW = (19.0 / 255.0, 9.0 / 255.0, 130.0 / 255.0)
COLOR_HIGH = (240.0 / 255.0, 103.0 / 255.0, 24.0 / 255.0)
LIGHT_DIR = (1.0, 1.0, 1.0)  # normalized below (compute_render.cu:67)

# ACES input/output matrices (color.cu:8-17). GLM mat3x3 constructor is
# column-major, so the rows here are the rows of the effective matrix.
_ACES_M1 = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_M2 = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def aces_planes(r, g, b):
    """ACES filmic tonemap on colour planes, clamped to [0, 1]
    (color.cu:7-22). The 3x3 products are written out elementwise: a
    float32 matrix product may run in reduced precision (TF32) on a GPU,
    and these stay exact float32 everywhere."""

    def mat(m, x, y, z):
        return (
            m[0][0] * x + m[0][1] * y + m[0][2] * z,
            m[1][0] * x + m[1][1] * y + m[1][2] * z,
            m[2][0] * x + m[2][1] * y + m[2][2] * z,
        )

    def curve(v):
        a = v * (v + 0.0245786) - 0.000090537
        bb = v * (0.983729 * v + 0.4329510) + 0.238081
        return a / bb

    vr, vg, vb = mat(_ACES_M1, r, g, b)
    rr, gg, bb = mat(_ACES_M2, curve(vr), curve(vg), curve(vb))
    clip = lambda v: jnp.clip(v, 0.0, 1.0)
    return clip(rr), clip(gg), clip(bb)


def aces_tonemap(rgb: jax.Array) -> jax.Array:
    """ACES filmic tonemap of ``(..., 3)`` colours (color.cu:7-22)."""
    return jnp.stack(aces_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2]), -1)


def shade_hits(
    sdf: Callable[[jax.Array], jax.Array],
    hit: RayMarchHit,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> jax.Array:
    """Shade a traced ray batch into linear RGB (compute_render.cu:67-89).

    Collision pixels mix two colors by ``(dot(n, light) + 1) / 2``; StepLimit
    pixels are white; DepthLimit pixels are black. Normals use the reference's
    4th-order finite difference by default (``use_grad_normal=True`` switches
    to the analytic ``jax.grad`` normal, which is cheaper and fuses better).
    """
    light = jnp.asarray(LIGHT_DIR, jnp.float32)
    light = light / jnp.linalg.norm(light)

    if use_grad_normal:
        normal = normal_grad(sdf, hit.position)
    else:
        normal = normal_fd4(sdf, hit.position, config.normal_epsilon)

    t = (jnp.sum(normal * light, axis=-1) + 1.0) / 2.0
    low = jnp.asarray(COLOR_LOW, jnp.float32)
    high = jnp.asarray(COLOR_HIGH, jnp.float32)
    collision_color = low + t[..., None] * (high - low)

    outcome = hit.outcome[..., None]
    color = jnp.where(outcome == COLLISION, collision_color, 0.0)
    color = jnp.where(outcome == STEP_LIMIT, 1.0, color)
    return aces_tonemap(color)


def to_rgba8(rgb: jax.Array) -> jax.Array:
    """Linear [0,1] RGB -> RGBA8 with opaque alpha (compute_render.cu:91-96).

    The reference C-casts ``clamp(c,0,1) * 255`` to unsigned char, which
    truncates; we match that truncation.
    """
    rgb8 = (jnp.clip(rgb, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    alpha = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([rgb8, alpha], axis=-1)


def render_image(
    sdf: Callable[[jax.Array], jax.Array],
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> jax.Array:
    """Trace + shade a full ray bundle to linear RGB ``(..., 3)``."""
    from bsdmg_tpu.ops.trace import sphere_trace

    hit = sphere_trace(sdf, origins, directions, cone_radius, config)
    return shade_hits(sdf, hit, config, use_grad_normal=use_grad_normal)


def shade_planes(nx, ny, nz, outcome):
    """Plane-form shading: Lambert two-color mix on collisions, white on
    step-limit, black otherwise, ACES tonemap. Returns ``(r, g, b)`` planes.
    The single source of truth for the reference's shading formula
    (compute_render.cu:67-89) on component data — used by the GPU render
    kernel, the SoA renderer and the differentiable SoA renderer. All
    constants are Python scalars, so a Pallas kernel can inline them."""
    inv = 1.0 / math.sqrt(
        LIGHT_DIR[0] ** 2 + LIGHT_DIR[1] ** 2 + LIGHT_DIR[2] ** 2
    )
    lx, ly, lz = (c * inv for c in LIGHT_DIR)
    t = (nx * lx + ny * ly + nz * lz + 1.0) * 0.5
    collided = outcome == COLLISION
    white = (outcome == STEP_LIMIT).astype(jnp.float32)
    r = jnp.where(collided, COLOR_LOW[0] + t * (COLOR_HIGH[0] - COLOR_LOW[0]), white)
    g = jnp.where(collided, COLOR_LOW[1] + t * (COLOR_HIGH[1] - COLOR_LOW[1]), white)
    b = jnp.where(collided, COLOR_LOW[2] + t * (COLOR_HIGH[2] - COLOR_LOW[2]), white)
    return aces_planes(r, g, b)


def render_image_c(
    csdf_p,
    params,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> jax.Array:
    """Component-form (SoA) trace + shade: same semantics as
    :func:`render_image` with the scene given as ``csdf_p(params, x, y, z)``
    (``Scene.csdf``) — the XLA renderer for any scene with a component form,
    including grid-SDF mesh assets. ``use_grad_normal`` selects forward-mode
    analytic normals over the reference's fd4 stencil."""
    from bsdmg_tpu.sdf.normals import normal_fd4_c, normal_jvp_c

    batch = origins.shape[:-1]
    cone = jnp.broadcast_to(jnp.asarray(cone_radius, jnp.float32), batch)
    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]
    f = lambda x, y, z: csdf_p(params, x, y, z)

    depth, _, outcome = march_planes(f, config, (ox, oy, oz), (dx, dy, dz), cone)
    px, py, pz = ox + depth * dx, oy + depth * dy, oz + depth * dz
    if use_grad_normal:
        nx, ny, nz = normal_jvp_c(f, px, py, pz)
    else:
        nx, ny, nz = normal_fd4_c(f, px, py, pz, config.normal_epsilon)

    r, g, b = shade_planes(nx, ny, nz, outcome)
    return jnp.stack([r, g, b], axis=-1)
