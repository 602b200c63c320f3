"""Sphere tracing (ray marching) with cone-radius adaptive thresholds.

Semantics match the reference tracer (cuda/includes/ray_marching.cu:14-49):

* collision when ``d <= cone_radius * depth + collision_distance``
* step size ``d - cone_radius * depth`` (the cone shrinks steps near grazing)
* outcomes: Collision / StepLimit (default) / DepthLimit
* ``steps`` counts completed advances (the reference's ``for`` increments
  after the body; breaks skip the increment)

Instead of one thread per ray with divergent loops, the whole ray batch
advances under a ``lax.while_loop`` with per-ray active masks — the loop
ends as soon as *every* ray in the batch has resolved. :func:`sphere_trace`
works on ``(..., 3)`` points; :func:`march_planes` is the same march on
coordinate planes (the form every renderer uses). The GPU render kernel in
``ops/pallas/render_triton.py`` runs :func:`march_planes` per pixel tile,
so early-finishing tiles stop iterating.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bsdmg_tpu.config import MarchConfig

# Outcome codes (reference: cuda/includes/bindings.h:12-14).
COLLISION = 0
STEP_LIMIT = 1
DEPTH_LIMIT = 2

SdfFn = Callable[[jax.Array], jax.Array]


class RayMarchHit(NamedTuple):
    """Batched ray-march result (reference struct: cuda/includes/types.cu:8-14).

    The reference's per-ray ``clock64()`` cycle counter is replaced by the
    profiling utilities in ``bsdmg_tpu.utils.profiling`` (whole-kernel
    timing)."""

    steps: jax.Array  # (...,) int32 completed advances
    position: jax.Array  # (..., 3) final march position
    depth: jax.Array  # (...,) distance travelled along the ray
    outcome: jax.Array  # (...,) int32: COLLISION / STEP_LIMIT / DEPTH_LIMIT


def sphere_trace(
    sdf: SdfFn,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius=0.0,
    config: MarchConfig = MarchConfig(),
) -> RayMarchHit:
    """March a batch of rays against ``sdf``.

    Args:
      sdf: scene SDF, ``(..., 3) -> (...,)``.
      origins/directions: ``(..., 3)`` ray bundle (directions unit length).
      cone_radius: scalar or ``(...,)`` per-ray cone radius at unit depth.
      config: step/depth/collision budget.

    Returns a :class:`RayMarchHit` of batched arrays.
    """
    batch = origins.shape[:-1]
    cone = jnp.broadcast_to(jnp.asarray(cone_radius, jnp.float32), batch)

    class State(NamedTuple):
        position: jax.Array
        depth: jax.Array
        steps: jax.Array
        outcome: jax.Array
        active: jax.Array

    init = State(
        position=origins,
        depth=jnp.zeros(batch, jnp.float32),
        steps=jnp.zeros(batch, jnp.int32),
        outcome=jnp.full(batch, STEP_LIMIT, jnp.int32),
        active=jnp.ones(batch, bool),
    )

    def cond(s: State) -> jax.Array:
        return jnp.any(s.active)

    def body(s: State) -> State:
        collision_distance = cone * s.depth
        d = sdf(s.position)

        hit = s.active & (d <= collision_distance + config.collision_distance)
        outcome = jnp.where(hit, COLLISION, s.outcome)

        advance = s.active & ~hit
        step = d - collision_distance
        depth = jnp.where(advance, s.depth + step, s.depth)
        position = jnp.where(
            advance[..., None], s.position + step[..., None] * directions, s.position
        )

        over_depth = advance & (depth > config.depth_limit)
        outcome = jnp.where(over_depth, DEPTH_LIMIT, outcome)

        survived = advance & ~over_depth
        steps = jnp.where(survived, s.steps + 1, s.steps)
        active = survived & (steps < config.step_limit)
        return State(position, depth, steps, outcome, active)

    final = jax.lax.while_loop(cond, body, init)
    return RayMarchHit(final.steps, final.position, final.depth, final.outcome)


def bb_parts(bb):
    """Split a static bounds tuple into ``(lo, hi, slack)``.

    ``scene_bounds``/``compile_scene_split`` emit 3-tuples whose last element
    is the scene-derived SDF under-estimation bound (smooth-min k/6 + eps);
    bare ``(lo, hi)`` tuples keep the conservative 0.1."""
    if len(bb) > 2:
        return bb[0], bb[1], float(bb[2])
    return bb[0], bb[1], 0.1


def slab_cull(ox, oy, oz, dx, dy, dz, lo, hi, cone, config: MarchConfig,
              slack: float = 0.1):
    """Tight conservative box cull: can this ray ever collide with a surface
    inside [lo, hi]^3? Returns ``(miss, t_exit)`` planes.

    A collision at ray parameter t needs ``f <= cone*t + eps`` and
    ``f >= |p(t) - c| - r - slack >= t - D - r - slack`` (c box center, r its
    half-diagonal, D = |origin - c|), so every collision has
    ``t <= T* = (D + r + slack + eps) / (1 - cone)`` and the colliding ray
    must pierce the box inflated by ``cone*T* + eps + slack``. ``t_exit`` is
    therefore a sound per-ray *stop* depth: beyond it no collision is
    possible. ``slack`` absorbs SDF under-estimation (smooth-min k/6) and must
    be >= the scene's actual undershoot — pass the value carried by
    ``scene_bounds``' 3-tuple (see :func:`bb_parts`).
    """
    eps = config.collision_distance
    cx = (lo[0] + hi[0]) * 0.5
    cy = (lo[1] + hi[1]) * 0.5
    cz = (lo[2] + hi[2]) * 0.5
    r = 0.5 * float(
        np.sqrt(
            (hi[0] - lo[0]) ** 2 + (hi[1] - lo[1]) ** 2 + (hi[2] - lo[2]) ** 2
        )
    )
    ex, ey, ez = ox - cx, oy - cy, oz - cz
    reach = jnp.sqrt(ex * ex + ey * ey + ez * ez) + r + slack + eps
    t_star = jnp.where(
        cone < 0.5, reach / jnp.maximum(1.0 - cone, 0.5), config.depth_limit
    )
    margin = cone * jnp.minimum(t_star, config.depth_limit) + eps + slack

    # per-ray slab test against [lo - margin, hi + margin]^3 (the
    # reference's scalar helper: signed_distance.cu:142-175)
    def axis(o, d, lo_a, hi_a):
        d_safe = jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
        inv = 1.0 / d_safe
        t1 = (lo_a - margin - o) * inv
        t2 = (hi_a + margin - o) * inv
        return jnp.minimum(t1, t2), jnp.maximum(t1, t2)

    nx, fx = axis(ox, dx, lo[0], hi[0])
    ny, fy = axis(oy, dy, lo[1], hi[1])
    nz, fz = axis(oz, dz, lo[2], hi[2])
    tmin = jnp.maximum(nx, jnp.maximum(ny, nz))
    tmax = jnp.minimum(fx, jnp.minimum(fy, fz))
    miss = tmax < jnp.maximum(tmin, 0.0)
    return miss, jnp.maximum(tmax, 0.0)


def march_planes(csdf, config: MarchConfig, o, d, cone, active0=None, *,
                 t_stop=None, chunk: int = 8, track_min: bool = False):
    """Sphere-trace coordinate planes; returns ``(depth, steps, outcome)``.

    Same semantics as :func:`sphere_trace` (ray_marching.cu:14-49) with the
    scene given as ``csdf(x, y, z)``. Rays with ``active0`` False do not
    march and report DepthLimit. A ray past ``t_stop`` (the exit depth of a
    slab that holds the whole scene, :func:`slab_cull`) can never collide
    and reports DepthLimit right there instead of marching empty space out
    to the depth limit.

    The batch-wide any-active reduction of the ``while`` condition is paid
    once per ``chunk`` steps (a ``fori_loop`` inside the ``while``), at the
    cost of at most ``chunk - 1`` masked iterations.

    ``track_min=True`` additionally returns ``(min_margin, t_min)`` — the
    per-ray minimum of the cone margin ``f - cone*t`` over every sampled
    point and the depth where it occurred (1e9 / 0 for never-sampled rays):
    the closest-approach record that silhouette-aware gradients
    differentiate (grad/edge.py).
    """
    eps = config.collision_distance
    ox, oy, oz = o
    dx, dy, dz = d
    limit = config.depth_limit if t_stop is None else t_stop
    if active0 is None:
        active0 = jnp.ones(cone.shape, bool)

    def step(_, carry):
        depth, steps, outcome, active_i = carry[:4]
        active = active_i > 0
        cd = cone * depth
        # positions are derived from depth instead of carried
        dist = csdf(ox + depth * dx, oy + depth * dy, oz + depth * dz)
        extra = ()
        if track_min:
            min_m, t_min = carry[4:]
            m = dist - cd
            upd = active & (m < min_m)
            extra = (jnp.where(upd, m, min_m), jnp.where(upd, depth, t_min))

        hit = active & (dist <= cd + eps)
        outcome = jnp.where(hit, COLLISION, outcome)
        advance = active & ~hit
        depth = jnp.where(advance, depth + dist - cd, depth)
        over = advance & (depth > limit)
        outcome = jnp.where(over, DEPTH_LIMIT, outcome)
        survived = advance & ~over
        steps = jnp.where(survived, steps + 1, steps)
        active = survived & (steps < config.step_limit)
        # masks are carried as int32: Triton and XLA both take them as-is
        return (depth, steps, outcome, active.astype(jnp.int32)) + extra

    def body(carry):
        state = jax.lax.fori_loop(0, chunk, step, carry[0])
        return state, jnp.sum(state[3])

    active0_i = active0.astype(jnp.int32)
    state0 = (
        jnp.zeros(cone.shape, jnp.float32),
        jnp.zeros(cone.shape, jnp.int32),
        jnp.where(active0, STEP_LIMIT, DEPTH_LIMIT).astype(jnp.int32),
        active0_i,
    )
    if track_min:
        # 1e9 == grad/edge.py::UNTRACKED — the closest-approach sentinel
        state0 += (jnp.full(cone.shape, 1e9, jnp.float32),
                   jnp.zeros(cone.shape, jnp.float32))
    state, _ = jax.lax.while_loop(
        lambda c: c[1] > 0, body, (state0, jnp.sum(active0_i))
    )
    return state[:3] + (state[4:] if track_min else ())
