"""Analytic SDF primitives and CSG combinators.

Capability parity with the reference's device-side SDF library
(``cuda/includes/signed_distance.cu``): every primitive is natively batched
over leading dims of ``p`` (shape ``(..., 3)``) so the whole scene evaluates
as fused element-wise code with no scalar loops.

Reference citations are ``file:line`` into ``/root/reference``.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

MAX_POSITIVE_F32 = 3.40282347e38
_SAFE_EPS = 1e-12


def _norm(v: jax.Array, axis: int = -1) -> jax.Array:
    """Euclidean norm along ``axis``; grad-safe at 0 (returns 0 gradient)."""
    sq = jnp.sum(v * v, axis=axis)
    return jnp.sqrt(jnp.maximum(sq, _SAFE_EPS))


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


# ---------------------------------------------------------------------------
# domain operators
# ---------------------------------------------------------------------------


def wrap(p: jax.Array, lower, higher) -> jax.Array:
    """Domain repetition: wrap each coordinate into [lower, higher).

    Reference: signed_distance.cu:9-18.
    """
    lower = jnp.asarray(lower)
    higher = jnp.asarray(higher)
    return lower + jnp.mod(p - lower, higher - lower)


def smooth_min(a: jax.Array, b: jax.Array, k) -> jax.Array:
    """Cubic polynomial smooth minimum with smoothing width ``k``.

    Reference: signed_distance.cu:20-23:
    ``h = max(k - |a-b|, 0)/k;  min(a,b) - h^3 * k / 6``.
    """
    h = jnp.maximum(k - jnp.abs(a - b), 0.0) / k
    return jnp.minimum(a, b) - h * h * h * k * (1.0 / 6.0)


def smooth_max(a: jax.Array, b: jax.Array, k) -> jax.Array:
    """Smooth maximum (dual of :func:`smooth_min`)."""
    return -smooth_min(-a, -b, k)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def sd_unit_sphere(p: jax.Array) -> jax.Array:
    """Sphere of *diameter* 1 at the origin (reference: signed_distance.cu:82-84)."""
    return _norm(p) - 0.5


def sd_sphere(p: jax.Array, center=0.0, radius=1.0) -> jax.Array:
    return _norm(p - jnp.asarray(center)) - radius


def sd_ray(p: jax.Array, origin, direction) -> jax.Array:
    """Distance to an infinite line through ``origin`` with unit ``direction``.

    Reference: signed_distance.cu:61-63 (named ``sd_ray`` there although it is
    the infinite line variant).
    """
    origin = jnp.asarray(origin)
    direction = jnp.asarray(direction)
    t = _dot(p - origin, direction)
    closest = origin + t[..., None] * direction
    return _norm(closest - p)


def sd_ray_segment(p: jax.Array, origin, direction, length) -> jax.Array:
    """Distance to a ray segment of given ``length`` (signed_distance.cu:65-75)."""
    origin = jnp.asarray(origin)
    direction = jnp.asarray(direction)
    t = jnp.clip(_dot(p - origin, direction), 0.0, length)
    closest = origin + t[..., None] * direction
    return _norm(closest - p)


def sd_line(p: jax.Array, b0, b1) -> jax.Array:
    """Distance to the segment [b0, b1] (signed_distance.cu:77-80)."""
    b0 = jnp.asarray(b0, dtype=jnp.result_type(p))
    b1 = jnp.asarray(b1, dtype=jnp.result_type(p))
    seg = b1 - b0
    length = _norm(seg)
    direction = seg / jnp.maximum(length, _SAFE_EPS)[..., None]
    return sd_ray_segment(p, b0, direction, length)


def sd_box(p: jax.Array, center=0.0, size=1.0) -> jax.Array:
    """Exact box SDF; ``size`` is the full extent (signed_distance.cu:86-91)."""
    q = jnp.abs(p - jnp.asarray(center)) - jnp.asarray(size) / 2.0
    outside = _norm(jnp.maximum(q, 0.0))
    inside = jnp.max(jnp.minimum(q, 0.0), axis=-1)
    return outside + inside


def sd_unit_cube(p: jax.Array) -> jax.Array:
    return sd_box(p, 0.0, 1.0)


def sd_simple_box(p: jax.Array, center, size) -> jax.Array:
    """Interior-only (non-exact outside) box distance (signed_distance.cu:115-118)."""
    q = jnp.abs(p - jnp.asarray(center)) - jnp.asarray(size) / 2.0
    return jnp.max(jnp.minimum(q, 0.0), axis=-1)


def sd_bounding_box(p: jax.Array, bb_min, bb_max) -> jax.Array:
    """Signed distance to an axis-aligned bounding *volume* in Chebyshev-ish
    form: max over the six half-space distances (signed_distance.cu:120-131).
    """
    bb_min = jnp.asarray(bb_min)
    bb_max = jnp.asarray(bb_max)
    return jnp.maximum(
        jnp.max(bb_min - p, axis=-1),
        jnp.max(p - bb_max, axis=-1),
    )


def _box_skeleton_edges(center, size, reference_compat: bool):
    """The 12 box edges as (12, 2, 3) segment endpoints, computed statically.

    The reference builds each edge from the low corner plus per-axis offsets
    (signed_distance.cu:93-113). Its offset for the ``(dir+1)%3`` axis indexes
    the size with ``(dir+1)%2`` — a bug that misplaces 8 of the 12 edges for
    non-cubic boxes (signed_distance.cu:101). ``reference_compat=True``
    reproduces that exact (buggy) geometry so renders match the reference;
    ``False`` builds a correct box skeleton.
    """
    center = jnp.asarray(center, dtype=jnp.float32)
    size = jnp.asarray(size, dtype=jnp.float32)
    center = jnp.broadcast_to(center, (3,))
    size = jnp.broadcast_to(size, (3,))
    low = center - size / 2.0

    starts = []
    ends = []
    for axis in range(3):
        a1 = (axis + 1) % 3
        a2 = (axis + 2) % 3
        # size component used for the offset along a1:
        s1 = (axis + 1) % 2 if reference_compat else a1
        s2 = a2  # the reference's a2 offset indexes correctly ((dir+2)%3)
        for c0 in (0, 1):
            for c1 in (0, 1):
                m0 = low
                if c0:
                    m0 = m0 + size[s1] * jnp.eye(3, dtype=jnp.float32)[a1]
                if c1:
                    m0 = m0 + size[s2] * jnp.eye(3, dtype=jnp.float32)[a2]
                m1 = m0 + size[axis] * jnp.eye(3, dtype=jnp.float32)[axis]
                starts.append(m0)
                ends.append(m1)
    return jnp.stack(starts), jnp.stack(ends)


def sd_box_skeleton(
    p: jax.Array,
    center,
    size,
    line_width,
    *,
    reference_compat: bool = True,
) -> jax.Array:
    """Rounded wireframe of a box: min over 12 capsule edges minus ``line_width``.

    Reference: signed_distance.cu:93-113. Evaluated batched: all 12 edges are
    computed against all points in one broadcast, so the whole skeleton fuses
    into one VPU pass instead of a scalar loop.
    """
    starts, ends = _box_skeleton_edges(center, size, reference_compat)
    # p: (..., 3) -> (..., 1, 3) against (12, 3)
    d = sd_line(p[..., None, :], starts, ends)  # (..., 12)
    return jnp.min(d, axis=-1) - line_width


# ---------------------------------------------------------------------------
# fractals
# ---------------------------------------------------------------------------

_MANDELBULB_POWER = 7.0
_MANDELBULB_ITERS = 25


def sd_mandelbulb(p: jax.Array, time=0.0) -> jax.Array:
    """Mandelbulb distance estimator ``0.5 * log(r) * r / dr``.

    Reference: signed_distance.cu:29-53 (power 7, 25 iterations, escape
    radius 2). The data-dependent ``break`` becomes a per-point active mask in
    a fixed-trip ``fori_loop`` so the whole batch stays vectorized.
    """
    p = jnp.asarray(p, dtype=jnp.float32)
    power = _MANDELBULB_POWER * (1.0 + jnp.asarray(time, jnp.float32) * 0.001)

    def body(_, carry):
        z, dr, r, active = carry
        r_new = _norm(z)
        r = jnp.where(active, r_new, r)
        cont = active & (r_new <= 2.0)

        safe_r = jnp.maximum(r_new, _SAFE_EPS)
        theta = jnp.arccos(jnp.clip(z[..., 2] / safe_r, -1.0, 1.0)) * power
        phi = jnp.arctan2(z[..., 1], z[..., 0]) * power
        zr = safe_r**power
        dr_next = safe_r ** (power - 1.0) * power * dr + 1.0

        s_theta = jnp.sin(theta)
        z_next = (
            zr[..., None]
            * jnp.stack(
                [s_theta * jnp.cos(phi), jnp.sin(phi) * s_theta, jnp.cos(theta)],
                axis=-1,
            )
            + p
        )
        z = jnp.where(cont[..., None], z_next, z)
        dr = jnp.where(cont, dr_next, dr)
        return z, dr, r, cont

    batch = p.shape[:-1]
    init = (
        p,
        jnp.ones(batch, jnp.float32),
        jnp.zeros(batch, jnp.float32),
        jnp.ones(batch, bool),
    )
    _, dr, r, _ = jax.lax.fori_loop(0, _MANDELBULB_ITERS, body, init)
    safe_r = jnp.maximum(r, _SAFE_EPS)
    return 0.5 * jnp.log(safe_r) * r / dr


def sd_unit_mandelbulb(p: jax.Array) -> jax.Array:
    """Mandelbulb rescaled to ~unit size (signed_distance.cu:55-57)."""
    return sd_mandelbulb(p / 0.4) * 0.4


# ---------------------------------------------------------------------------
# AABB helpers
# ---------------------------------------------------------------------------


def inside_aabb(p: jax.Array, bb_min, bb_max) -> jax.Array:
    """Componentwise containment test (signed_distance.cu:137-140)."""
    bb_min = jnp.asarray(bb_min)
    bb_max = jnp.asarray(bb_max)
    return jnp.all((bb_min <= p) & (p <= bb_max), axis=-1)


def ray_distance_to_bb(origin: jax.Array, direction: jax.Array, bb_min, bb_max) -> jax.Array:
    """Slab test: distance along the ray to the AABB, 0 if inside, +FLT_MAX on miss.

    Reference: signed_distance.cu:142-175, vectorized without the per-axis
    early-outs (the mask algebra reproduces the same result).
    """
    bb_min = jnp.asarray(bb_min, dtype=jnp.float32)
    bb_max = jnp.asarray(bb_max, dtype=jnp.float32)
    eps = jnp.finfo(jnp.float32).eps

    parallel = jnp.abs(direction) < eps
    safe_dir = jnp.where(parallel, 1.0, direction)
    ood = 1.0 / safe_dir
    t1 = (bb_min - origin) * ood
    t2 = (bb_max - origin) * ood
    t_near = jnp.where(parallel, -MAX_POSITIVE_F32, jnp.minimum(t1, t2))
    t_far = jnp.where(parallel, MAX_POSITIVE_F32, jnp.maximum(t1, t2))

    tmin = jnp.max(t_near, axis=-1)
    tmax = jnp.min(t_far, axis=-1)

    parallel_miss = jnp.any(parallel & ((origin < bb_min) | (origin > bb_max)), axis=-1)
    miss = parallel_miss | (tmin > tmax)

    dist = jnp.where(tmin > 0, tmin, tmax)
    dist = jnp.where(miss, MAX_POSITIVE_F32, dist)
    return jnp.where(inside_aabb(origin, bb_min, bb_max), 0.0, dist)


# ---------------------------------------------------------------------------
# Component-form (SoA) primitives with traced parameters
#
# These mirror the point-API primitives above but take coordinate planes
# (x, y, z) and keep parameters as traced JAX scalars/vectors, so they are
# differentiable w.r.t. params and free of a trailing length-3 axis.
# Used by the differentiable render path (bsdmg_tpu/grad) and any caller
# that wants gradients through a fast SDF.
# ---------------------------------------------------------------------------


def _vec3(v):
    """A 3-vector parameter as a tuple of scalars.

    Accepts a (3,) array, a scalar, or a tuple/list of (traced) scalars."""
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (v[0], v[0], v[0])
        return tuple(v)
    v = jnp.asarray(v, jnp.float32)
    if v.ndim == 0:
        return (v, v, v)
    v = jnp.broadcast_to(v, (3,))
    return (v[0], v[1], v[2])


def sd_sphere_c(x, y, z, center, radius):
    """Component form of :func:`sd_sphere`."""
    c = _vec3(center)
    dx, dy, dz = x - c[0], y - c[1], z - c[2]
    return jnp.sqrt(dx * dx + dy * dy + dz * dz) - radius


def sd_box_c(x, y, z, center, size):
    """Component form of :func:`sd_box` (exact box SDF, signed inside)."""
    c = _vec3(center)
    s = _vec3(size)
    qx = jnp.abs(x - c[0]) - s[0] * 0.5
    qy = jnp.abs(y - c[1]) - s[1] * 0.5
    qz = jnp.abs(z - c[2]) - s[2] * 0.5
    ox = jnp.maximum(qx, 0.0)
    oy = jnp.maximum(qy, 0.0)
    oz = jnp.maximum(qz, 0.0)
    outside = jnp.sqrt(ox * ox + oy * oy + oz * oz)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    return outside + inside


def sd_torus_c(x, y, z, center, major_radius, minor_radius):
    """Component-form torus in the xz plane (ring of ``major_radius``,
    tube of ``minor_radius``)."""
    c = _vec3(center)
    px, py, pz = x - c[0], y - c[1], z - c[2]
    ring = jnp.sqrt(px * px + pz * pz) - major_radius
    return jnp.sqrt(ring * ring + py * py) - minor_radius


def sd_cylinder_c(x, y, z, center, radius, height):
    """Component-form capped cylinder along +y (exact SDF)."""
    c = _vec3(center)
    px, py, pz = x - c[0], y - c[1], z - c[2]
    dr = jnp.sqrt(px * px + pz * pz) - radius
    dy = jnp.abs(py) - height * 0.5
    ox = jnp.maximum(dr, 0.0)
    oy = jnp.maximum(dy, 0.0)
    return jnp.minimum(jnp.maximum(dr, dy), 0.0) + jnp.sqrt(ox * ox + oy * oy)


def sd_box_skeleton_c(x, y, z, center, size, line_width, *, reference_compat=True):
    """Component form of :func:`sd_box_skeleton` (signed_distance.cu:93-113).

    Exploits two algebraic identities over the 12 axis-aligned edges:
    same-radius capsules share one sqrt (min commutes with sqrt), and each
    4-edge parallel group's perpendicular offsets form a cross product, so
    the min over the group factorizes into axial + min(V1) + min(V2).
    ``reference_compat=True`` reproduces the reference's ``bs[(dir+1)%2]``
    index bug (signed_distance.cu:101).
    """
    center = _vec3(center)
    size = _vec3(size)
    coords = (x, y, z)
    lo = tuple(c - s / 2.0 for c, s in zip(center, size))

    best = None
    for d in range(3):
        a1, a2 = (d + 1) % 3, (d + 2) % 3
        r = coords[d] - lo[d]
        t = jnp.clip(r, 0.0, size[d])
        e = r - t
        axial = e * e
        # perp offsets: {lo, lo + s} on each of the two other axes; the
        # compat bug indexes the first offset's size with (d+1)%2
        s1 = size[(d + 1) % 2] if reference_compat else size[a1]
        o1 = coords[a1] - lo[a1]
        o1b = o1 - s1
        o2 = coords[a2] - lo[a2]
        o2b = o2 - size[a2]
        m1 = jnp.minimum(o1 * o1, o1b * o1b)
        m2 = jnp.minimum(o2 * o2, o2b * o2b)
        d2 = axial + m1 + m2
        best = d2 if best is None else jnp.minimum(best, d2)
    return jnp.sqrt(best) - line_width


def sd_mandelbulb_c(x, y, z, time=0.0):
    """Component form of :func:`sd_mandelbulb` (signed_distance.cu:29-53) —
    coordinate planes in, distance plane out."""
    # a static time keeps the exponent a Python float, which a kernel inlines
    if isinstance(time, (int, float)):
        power = float(_MANDELBULB_POWER * (1.0 + time * 0.001))
    else:
        power = _MANDELBULB_POWER * (1.0 + jnp.asarray(time, jnp.float32) * 0.001)

    def body(_, carry):
        zx, zy, zz, dr, r, active_i = carry
        active = active_i > 0
        r_new = jnp.sqrt(zx * zx + zy * zy + zz * zz)
        r = jnp.where(active, r_new, r)
        cont = active & (r_new <= 2.0)

        safe_r = jnp.maximum(r_new, _SAFE_EPS)
        theta = jnp.arccos(jnp.clip(zz / safe_r, -1.0, 1.0)) * power
        phi = jnp.arctan2(zy, zx) * power
        zr = safe_r**power
        dr_next = safe_r ** (power - 1.0) * power * dr + 1.0

        s_theta = jnp.sin(theta)
        zx_n = zr * s_theta * jnp.cos(phi) + x
        zy_n = zr * jnp.sin(phi) * s_theta + y
        zz_n = zr * jnp.cos(theta) + z
        zx = jnp.where(cont, zx_n, zx)
        zy = jnp.where(cont, zy_n, zy)
        zz = jnp.where(cont, zz_n, zz)
        dr = jnp.where(cont, dr_next, dr)
        return zx, zy, zz, dr, r, cont.astype(jnp.int32)

    init = (
        x, y, z,
        jnp.ones_like(x),
        jnp.zeros_like(x),
        jnp.ones(x.shape, jnp.int32),
    )
    _, _, _, dr, r, _ = jax.lax.fori_loop(0, _MANDELBULB_ITERS, body, init)
    safe_r = jnp.maximum(r, _SAFE_EPS)
    return 0.5 * jnp.log(safe_r) * r / dr
