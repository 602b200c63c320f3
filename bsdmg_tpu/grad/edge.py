"""Silhouette-aware gradient terms for inverse rendering.

IFT reattachment (grad/diff_render.py) differentiates pixels whose outcome
is stable; outcome flips (hit <-> miss) are step discontinuities that carry
no gradient, so an image-loss fit is only valid inside a small basin
(measured ~±6% in sphere radius at round 2). This module adds the missing
boundary information with an **envelope-theorem closest-approach loss**:

* the march records, per ray, ``min_margin = min_t (f(x(t)) - cone*t)`` and
  the depth ``t_min`` where it occurred (``ops.trace.march_planes(track_min=True)``);
* by the envelope theorem, ``d(min_margin)/dparams`` is just the parameter
  gradient of ONE SDF eval at the recorded point (``t_min`` held fixed);
* pixels whose *outcome* disagrees with the target get a hinge on that
  margin: rays that should hit but miss drive their positive closest-
  approach margin to zero ("appear"); rays that hit but should miss push
  the margin past a small band ("vanish"). Once the outcome flips, the
  ordinary photometric IFT gradients take over.

This is the SDF analogue of the silhouette terms in differentiable
rasterizers/path-tracers, but needs no edge sampling: sphere tracing
already visits the closest-approach point of every miss ray.

The reference renderer (compute_render.cu) is forward-only; the whole
differentiable stack is this framework's extension (BASELINE north star).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: min_margin sentinel for rays the march never sampled (slab-culled sky).
#: MUST equal the initializer the march writes
#: (ops/trace.py::march_planes) —
#: a single source of truth for "this ray carries no closest-approach
#: record". Comparisons use strict ``<`` so the sentinel itself reads as
#: untracked.
UNTRACKED = 1e9


def classify_target_miss(target: jax.Array) -> jax.Array:
    """Per-pixel miss mask from a rendered/observed RGB target.

    The reference palette (compute_render.cu:73-97) makes the three
    outcomes separable after ACES: DepthLimit is black (0,0,0), StepLimit
    is white — ACES(1,1,1) with the shipped Hill-fit constants is exactly
    0.6191 per channel (ops/shade.py::aces_tonemap; both ACES matrices
    have unit row sums) — and collisions interpolate COLOR_LOW..COLOR_HIGH
    whose min channel stays < 0.35 and max channel > 0.2. The white
    threshold sits at 0.5, ~0.12 below the actual white, so targets that
    went through mild darkening (exposure tweaks, lossy encode, bilinear
    resampling at silhouettes) still classify StepLimit pixels as misses.
    Returns ``True`` where the target shows no surface (black or white).
    """
    mx = jnp.max(target, axis=-1)
    mn = jnp.min(target, axis=-1)
    return (mx < 0.05) | (mn > 0.5)


def edge_loss_planes(
    f,
    ox, oy, oz, dx, dy, dz,
    cone,
    t_min,
    min_margin,
    collided,
    target_state,
    band: float,
):
    """Per-pixel silhouette hinge loss on coordinate planes (unreduced).

    Args:
      f: component SDF ``f(x, y, z)`` with the TRACED params closed over —
        the one expression the envelope gradient differentiates.
      t_min, min_margin: the march's closest-approach record. Callers must
        pass them ``stop_gradient``-ed (they are Lagrangian multipliers,
        not variables).
      collided: bool plane, current render hit.
      target_state: f32 plane: 0 = target hit, 1 = target miss,
        -1 = ignore (padding lanes).
      band: margin the vanish hinge pushes past (> collision_distance so
        the hinge releases only once the ray genuinely misses).

    Returns the per-pixel LINEAR hinge (appear + vanish), zero wherever
    outcomes already agree. Linear, not squared: a vanish pixel's recorded
    margin sits within ``collision_distance`` of zero no matter how deep
    the surface overshoots, so a squared hinge would be bounded by
    ``band**2`` (~1e-5) and vanish against the photometric loss; the
    linear hinge exerts constant outward pressure until the outcome flips
    and the photometric gradient takes over.
    """
    valid = target_state > -0.5
    tgt_miss = target_state > 0.5
    tracked = min_margin < UNTRACKED
    ex = ox + t_min * dx
    ey = oy + t_min * dy
    ez = oz + t_min * dz
    m = f(ex, ey, ez) - cone * t_min

    appear = valid & ~tgt_miss & ~collided & tracked
    vanish = valid & tgt_miss & collided
    e_app = jnp.maximum(m, 0.0)
    e_van = jnp.maximum(band - m, 0.0)
    return (
        jnp.where(appear, e_app, 0.0) + jnp.where(vanish, e_van, 0.0)
    )
