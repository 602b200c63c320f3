"""Differentiable sphere-traced rendering w.r.t. SDF parameters.

The reference renderer is forward-only; differentiability is this framework's
extension (the BASELINE north star: pixel gradients w.r.t. SDF params must
match finite differences).

Design: backprop through 256 march iterations would be slow and numerically
fragile, so the march itself runs under ``stop_gradient`` and the hit is
*reattached* differentiably via the implicit function theorem. The accepted
hit satisfies (to first order)::

    f(o + t d, theta) - cone * t - eps = 0

so ``dt/dtheta = -(df/dtheta) / (grad_f . d - cone)`` at the root. One
differentiable Newton correction around the stopped ``t`` has exactly this
Jacobian::

    t* = t - (f(o + t d, theta) - cone*t - eps) / stop_grad(grad_f . d - cone)

Downstream shading (normals from ``jax.grad`` of the SDF, Lambert mix, ACES)
is then an ordinary differentiable program. Miss pixels keep constant colors:
the Collision/miss boundary is a step discontinuity, so gradients are defined
away from silhouettes (tests compare against finite differences on stable
pixels).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.ops.shade import COLOR_HIGH, COLOR_LOW, LIGHT_DIR, aces_tonemap
from bsdmg_tpu.ops.trace import COLLISION, STEP_LIMIT, RayMarchHit, sphere_trace

SceneFn = Callable[[Any, jax.Array], jax.Array]


def differentiable_hit(
    scene: SceneFn,
    params: Any,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
) -> tuple[jax.Array, RayMarchHit]:
    """Trace and return ``(t_diff, hit)`` where ``t_diff`` carries implicit
    gradients w.r.t. ``params`` for collision rays."""
    stopped = jax.tree.map(jax.lax.stop_gradient, params)
    sdf_stopped = lambda p: scene(stopped, p)
    hit = sphere_trace(sdf_stopped, origins, directions, cone_radius, config)

    t0 = jax.lax.stop_gradient(hit.depth)
    x0 = origins + t0[..., None] * directions

    # d f / d t along the ray, with params stopped (IFT denominator)
    def f_of_t(t):
        return jnp.sum(scene(stopped, origins + t[..., None] * directions))

    dfdt = jax.grad(f_of_t)(t0)
    denom = dfdt - jnp.broadcast_to(jnp.asarray(cone_radius), t0.shape)
    # rays approach the surface from outside: dfdt < 0 at a hit; guard zeros
    denom = jnp.where(jnp.abs(denom) < 1e-6, -1e-6, denom)
    denom = jax.lax.stop_gradient(denom)

    residual = scene(params, x0) - jnp.asarray(cone_radius) * t0 - config.collision_distance
    t_diff = t0 - residual / denom

    collided = hit.outcome == COLLISION
    t_diff = jnp.where(collided, t_diff, t0)
    return t_diff, hit


def _shade_diff(scene: SceneFn, params, positions: jax.Array, outcome: jax.Array):
    light = jnp.asarray(LIGHT_DIR, jnp.float32)
    light = light / jnp.linalg.norm(light)

    def point_normal(p):
        g = jax.grad(lambda q: scene(params, q[None, :])[0])(p)
        return g / jnp.maximum(jnp.linalg.norm(g), 1e-12)

    flat = positions.reshape(-1, 3)
    normals = jax.vmap(point_normal)(flat).reshape(positions.shape)

    t = (jnp.sum(normals * light, axis=-1) + 1.0) / 2.0
    low = jnp.asarray(COLOR_LOW, jnp.float32)
    high = jnp.asarray(COLOR_HIGH, jnp.float32)
    collision_color = low + t[..., None] * (high - low)

    o = outcome[..., None]
    color = jnp.where(o == COLLISION, collision_color, 0.0)
    color = jnp.where(o == STEP_LIMIT, 1.0, color)
    return aces_tonemap(color)


def render_image_diff(
    scene: SceneFn,
    params: Any,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
    csdf=None,
    bb: tuple | None = None,
) -> jax.Array:
    """Differentiable render: linear RGB ``(..., 3)`` with gradients flowing
    to ``params`` through hit depth and shading normals.

    ``csdf`` — the scene's component-form twin ``f(params, x, y, z)``
    (``Scene.csdf``) — switches to the SoA path: coordinate planes instead
    of (..., 3) points, same math. ``bb`` (optional, SoA path) enables the
    sky slab cull — supply bounds covering the surface over the
    optimization's whole parameter range.
    """
    if csdf is not None:
        return _render_image_diff_c(
            csdf, params, origins, directions, cone_radius, config, bb=bb
        )
    t_diff, hit = differentiable_hit(
        scene, params, origins, directions, cone_radius, config
    )
    positions = origins + t_diff[..., None] * directions
    return _shade_diff(scene, params, positions, hit.outcome)


def _render_image_diff_c(
    csdf,
    params: Any,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
    bb: tuple | None = None,
    return_aux: bool = False,
):
    """Component-form differentiable render (same semantics as the points
    path; gradients via the implicit function theorem at the hit).

    The forward march runs in XLA under ``stop_gradient`` — it carries no
    gradients (IFT reattachment below). ``bb`` (optional) turns on the sky
    slab cull; it must conservatively bound the surface over the whole
    parameter trust region of the optimization.

    ``return_aux=True`` returns ``(image, aux)`` where ``aux`` is the
    stopped ``(outcome, min_margin, t_min)`` closest-approach record the
    silhouette-aware loss consumes (grad/edge.py)."""
    from bsdmg_tpu.ops.trace import bb_parts, march_planes, slab_cull

    batch = origins.shape[:-1]
    cone = jnp.broadcast_to(jnp.asarray(cone_radius, jnp.float32), batch)
    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]

    stopped = jax.tree.map(jax.lax.stop_gradient, params)
    f0 = lambda x, y, z: csdf(stopped, x, y, z)

    active0 = t_stop = None
    if bb is not None:
        lo, hi, slack = bb_parts(bb)
        miss, t_exit = slab_cull(ox, oy, oz, dx, dy, dz, lo, hi, cone, config, slack)
        active0 = ~miss
        t_stop = jnp.minimum(t_exit, config.depth_limit)
    outs = march_planes(
        f0, config, (ox, oy, oz), (dx, dy, dz), cone, active0,
        t_stop=t_stop, track_min=return_aux,
    )
    depth, _, outcome = outs[:3]
    t0 = jax.lax.stop_gradient(depth)
    px, py, pz = ox + t0 * dx, oy + t0 * dy, oz + t0 * dz
    # IFT denominator: df/dt along the ray at the hit, params stopped
    _, dfdt = jax.jvp(f0, (px, py, pz), (dx, dy, dz))
    denom = dfdt - cone
    denom = jnp.where(jnp.abs(denom) < 1e-6, -1e-6, denom)
    denom = jax.lax.stop_gradient(denom)

    residual = csdf(params, px, py, pz) - cone * t0 - config.collision_distance
    t_diff = t0 - residual / denom
    collided = outcome == COLLISION
    t_diff = jnp.where(collided, t_diff, t0)

    qx, qy, qz = ox + t_diff * dx, oy + t_diff * dy, oz + t_diff * dz
    # shading normal via ONE reverse-mode pass (pixels are independent, so
    # grad-of-sum gives every pixel's spatial gradient in ~3 eval-equivalents
    # vs normal_jvp_c's three forward passes; still differentiable w.r.t.
    # params for the backward)
    gx, gy, gz = jax.grad(
        lambda x, y, z: jnp.sum(csdf(params, x, y, z)), argnums=(0, 1, 2)
    )(qx, qy, qz)
    inv = jax.lax.rsqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, 1e-24))
    nx, ny, nz = gx * inv, gy * inv, gz * inv

    from bsdmg_tpu.ops.shade import shade_planes

    r, g, b = shade_planes(nx, ny, nz, outcome)
    img = jnp.stack([r, g, b], axis=-1)
    if return_aux:
        min_m, t_min = outs[3:]
        return img, (outcome, jax.lax.stop_gradient(min_m),
                     jax.lax.stop_gradient(t_min))
    return img


def render_loss_and_grad(
    scene: SceneFn,
    params: Any,
    target: jax.Array,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius: jax.Array,
    config: MarchConfig = MarchConfig(),
    csdf=None,
    bb: tuple | None = None,
    edge_weight: float = 0.0,
    edge_band: float | None = None,
    target_miss: jax.Array | None = None,
):
    """L2 image loss against ``target`` and its gradient w.r.t. ``params`` —
    the inverse-rendering training step: ``jax.value_and_grad`` of the
    differentiable render.

    ``edge_weight > 0`` adds the silhouette-aware closest-approach loss
    (grad/edge.py): outcome-mismatched pixels pull the surface toward /
    away from their rays, extending the fit's convergence basin far beyond
    the photometric-only ±6%. Requires a component-form ``csdf``.
    ``target_miss`` overrides the target's miss mask (else classified from
    RGB); ``edge_band`` defaults to ``4 * config.collision_distance``.
    """
    edge_weight = float(edge_weight)
    if edge_weight and csdf is None:
        raise ValueError(
            "edge_weight > 0 requires a component-form csdf (the closest-"
            "approach record lives on the SoA march)"
        )
    band = (
        4.0 * config.collision_distance if edge_band is None
        else float(edge_band)
    )

    if not edge_weight:
        def loss_fn(p):
            img = render_image_diff(
                scene, p, origins, directions, cone_radius, config,
                csdf=csdf, bb=bb,
            )
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss_fn)(params)

    from bsdmg_tpu.grad.edge import classify_target_miss, edge_loss_planes

    tgt_state = (
        classify_target_miss(target) if target_miss is None else target_miss
    ).astype(jnp.float32)
    batch = origins.shape[:-1]
    cone = jnp.broadcast_to(jnp.asarray(cone_radius, jnp.float32), batch)
    n_pixels = 1
    for s in batch:
        n_pixels *= s

    def loss_fn(p):
        img, (outcome, min_m, t_min) = _render_image_diff_c(
            csdf, p, origins, directions, cone_radius, config,
            bb=bb, return_aux=True,
        )
        loss = jnp.mean((img - target) ** 2)
        edge = edge_loss_planes(
            lambda x, y, z: csdf(p, x, y, z),
            origins[..., 0], origins[..., 1], origins[..., 2],
            directions[..., 0], directions[..., 1], directions[..., 2],
            cone, t_min, min_m, outcome == COLLISION, tgt_state, band,
        )
        return loss + edge_weight * jnp.sum(edge) / n_pixels

    return jax.value_and_grad(loss_fn)(params)
