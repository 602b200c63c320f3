"""Surface normals and isosurface projection.

Two normal paths:

* :func:`normal_grad` — idiomatic JAX: the analytic gradient of the SDF via
  ``jax.grad``, which XLA fuses with the surrounding program.
* :func:`normal_fd4` — the reference's 4th-order central difference with
  ``eps=1e-3`` (cuda/includes/signed_distance.cu:179-202), kept bit-compatible
  for golden-image parity.

Plus :func:`closest_surface_point`, the Newton projection the reference runs
per marching-cubes vertex (signed_distance.cu:227-240) — bounded here to a
static iteration count with a convergence mask instead of the reference's
data-dependent loop of up to 10,000 steps.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

_SAFE_EPS = 1e-12

SdfFn = Callable[[jax.Array], jax.Array]
"""A scene SDF: points (..., 3) -> distances (...,)."""


def _normalize(v: jax.Array) -> jax.Array:
    n = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), _SAFE_EPS))
    return v / n


def normal_grad(sdf: SdfFn, p: jax.Array) -> jax.Array:
    """Unit normal from the analytic SDF gradient (jax.grad)."""
    flat = p.reshape(-1, 3)
    g = jax.vmap(jax.grad(lambda q: jnp.sum(sdf(q[None, :]))))(flat)
    return _normalize(g).reshape(p.shape)


def normal_fd4(sdf: SdfFn, p: jax.Array, eps: float = 1e-3) -> jax.Array:
    """4th-order central-difference unit normal, 12 SDF evals per point.

    Matches the reference stencil (signed_distance.cu:181-202):
    ``-f(p+2e) + 8 f(p+e) - 8 f(p-e) + f(p-2e)`` per axis (the 1/(12 eps)
    factor cancels under normalization, as in the reference). All 12 offset
    evaluations run as one batched call so the scene fuses once.
    """
    eye = jnp.eye(3, dtype=p.dtype)
    # offsets: (12, 3) = 4 taps x 3 axes
    taps = jnp.asarray([2.0, 1.0, -1.0, -2.0], dtype=p.dtype)
    offsets = (taps[:, None, None] * eye[None, :, :]).reshape(12, 3) * eps
    # (..., 12, 3)
    samples = sdf(p[..., None, :] + offsets)  # (..., 12)
    s = samples.reshape(*samples.shape[:-1], 4, 3)
    # elementwise, not a contraction: a float32 einsum may run in TF32 on a
    # GPU, which would lose the stencil's cancellation
    grads = -s[..., 0, :] + 8.0 * s[..., 1, :] - 8.0 * s[..., 2, :] + s[..., 3, :]
    return _normalize(grads)


def normal_plane(sdf: SdfFn, p: jax.Array, eps: float = 1e-3):
    """Tangent frame (up, forward, right) at ``p``.

    Reference: signed_distance.cu:210-225. ``up`` is the surface normal,
    ``right = up x ref`` where ref is +Z unless the normal is nearly parallel
    to it, and ``forward = up x right``.
    """
    up = normal_fd4(sdf, p, eps)
    z = jnp.asarray([0.0, 0.0, 1.0], dtype=p.dtype)
    y = jnp.asarray([0.0, 1.0, 0.0], dtype=p.dtype)
    use_z = jnp.abs(jnp.sum(up * z, axis=-1, keepdims=True)) < 0.5
    ref = jnp.where(use_z, z, y)
    right = jnp.cross(up, jnp.broadcast_to(ref, up.shape))
    forward = jnp.cross(up, right)
    return up, forward, right


def closest_surface_point(
    sdf: SdfFn,
    p: jax.Array,
    *,
    iters: int = 24,
    tolerance: float = 1e-5,
    eps: float = 1e-3,
    use_grad_normal: bool = False,
    mask: jax.Array | None = None,
) -> jax.Array:
    """Project points onto the zero isosurface: ``g <- g - sd(g) * n(g)``.

    Reference: signed_distance.cu:227-240 (up to 10,000 data-dependent
    iterations, tol 1e-5). Here a bounded ``while_loop`` with a
    per-point convergence mask — Newton converges in a handful of steps on a
    well-behaved SDF, verified by surface-distance assertions in tests.
    """
    normal_fn = normal_grad if use_grad_normal else (lambda f, q: normal_fd4(f, q, eps))

    def cond(carry):
        _, done, i = carry
        return (~jnp.all(done)) & (i < iters)

    def body(carry):
        g, done, i = carry
        sd = sdf(g)
        n = normal_fn(sdf, g)
        g_next = g - sd[..., None] * n
        newly_done = jnp.abs(sd) <= tolerance
        g = jnp.where(done[..., None], g, g_next)
        return g, done | newly_done, i + 1

    # masked-off points are treated as already converged (the loop exits as
    # soon as every *live* point is within tolerance)
    done0 = (
        jnp.zeros(p.shape[:-1], bool) if mask is None else ~mask.astype(bool)
    )
    g, _, _ = jax.lax.while_loop(cond, body, (p, done0, jnp.int32(0)))
    return g


# ---------------------------------------------------------------------------
# Component-form (SoA) variants
#
# These variants take and return coordinate *planes* (x, y, z of any equal
# shape) and evaluate a component SDF ``csdf(x, y, z) -> d``, so no array
# carries a trailing length-3 axis. Wrap an (N, 3) SDF with
# :func:`as_component` when no native csdf exists.
# ---------------------------------------------------------------------------


def as_component(sdf: SdfFn):
    """Adapt a points-API SDF to the component signature (no speedup — the
    stack re-creates the AoS layout — but lets one code path serve both)."""

    def csdf(x, y, z):
        return sdf(jnp.stack([x, y, z], axis=-1))

    return csdf


def normal_fd4_c(csdf, x, y, z, eps: float = 1e-3):
    """4th-order FD unit normal on planes; returns ``(nx, ny, nz)``.

    Same stencil as :func:`normal_fd4` (signed_distance.cu:181-202)."""

    def deriv(fp2, fp1, fm1, fm2):
        return -fp2 + 8.0 * fp1 - 8.0 * fm1 + fm2

    gx = deriv(
        csdf(x + 2 * eps, y, z), csdf(x + eps, y, z),
        csdf(x - eps, y, z), csdf(x - 2 * eps, y, z),
    )
    gy = deriv(
        csdf(x, y + 2 * eps, z), csdf(x, y + eps, z),
        csdf(x, y - eps, z), csdf(x, y - 2 * eps, z),
    )
    gz = deriv(
        csdf(x, y, z + 2 * eps), csdf(x, y, z + eps),
        csdf(x, y, z - eps), csdf(x, y, z - 2 * eps),
    )
    inv = jax.lax.rsqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, _SAFE_EPS))
    return gx * inv, gy * inv, gz * inv


def closest_surface_point_c(
    csdf,
    x: jax.Array,
    y: jax.Array,
    z: jax.Array,
    *,
    iters: int = 24,
    tolerance: float = 1e-5,
    eps: float = 1e-3,
    mask: jax.Array | None = None,
):
    """Newton projection on coordinate planes (signed_distance.cu:227-240).

    Returns ``(x, y, z)`` projected onto the isosurface. Early-exits when all
    live points are within ``tolerance``.
    """

    def cond(carry):
        _, _, _, done, i = carry
        return (~jnp.all(done)) & (i < iters)

    def body(carry):
        gx, gy, gz, done, i = carry
        sd = csdf(gx, gy, gz)
        nx, ny, nz = normal_fd4_c(csdf, gx, gy, gz, eps)
        keep = done
        gx = jnp.where(keep, gx, gx - sd * nx)
        gy = jnp.where(keep, gy, gy - sd * ny)
        gz = jnp.where(keep, gz, gz - sd * nz)
        return gx, gy, gz, done | (jnp.abs(sd) <= tolerance), i + 1

    done0 = jnp.zeros(x.shape, bool) if mask is None else ~mask.astype(bool)
    gx, gy, gz, _, _ = jax.lax.while_loop(
        cond, body, (x, y, z, done0, jnp.int32(0))
    )
    return gx, gy, gz


def normal_jvp_c(csdf, x, y, z):
    """Analytic unit normal on planes via three forward-mode JVPs (~6
    eval-equivalents vs fd4's 12). The component-form counterpart of
    :func:`normal_grad`."""
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    _, gx = jax.jvp(csdf, (x, y, z), (one, zero, zero))
    _, gy = jax.jvp(csdf, (x, y, z), (zero, one, zero))
    _, gz = jax.jvp(csdf, (x, y, z), (zero, zero, one))
    inv = jax.lax.rsqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, _SAFE_EPS))
    return gx * inv, gy * inv, gz * inv
