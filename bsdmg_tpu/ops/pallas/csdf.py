"""Component-form SDFs with baked parameters.

A *component SDF* ("csdf") takes three same-shape coordinate planes and
returns a distance plane, so no array carries a trailing length-3 axis::

    csdf(x, y, z) -> d      # all (S, L) arrays

:func:`compile_scene_csdf` lowers the built-in scene families (reference
object/render scene, sphere, box, capsule sets) to component form with the
parameters baked as compile-time constants — the right trade for a render
kernel that retraces only when the scene changes (a Pallas kernel inlines
Python-float constants). Scenes outside the registry fall back to the
param-traced ``Scene.csdf``.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from bsdmg_tpu.models.scenes import Scene
from bsdmg_tpu.sdf.primitives import _box_skeleton_edges

CSdf = Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], jnp.ndarray]


def smooth_min_c(a, b, k: float):
    """Cubic smooth-min on planes (signed_distance.cu:20-23)."""
    h = jnp.maximum(k - jnp.abs(a - b), 0.0) * (1.0 / k)
    return jnp.minimum(a, b) - h * h * h * (k / 6.0)


def sphere_csdf(cx: float, cy: float, cz: float, radius: float) -> CSdf:
    def f(x, y, z):
        dx, dy, dz = x - cx, y - cy, z - cz
        return jnp.sqrt(dx * dx + dy * dy + dz * dz) - radius

    return f


def box_csdf(center, size) -> CSdf:
    from bsdmg_tpu.sdf.primitives import sd_box_c

    c = tuple(float(v) for v in np.broadcast_to(center, (3,)))
    s = tuple(float(v) for v in np.broadcast_to(size, (3,)))

    def f(x, y, z):
        return sd_box_c(x, y, z, c, s)

    return f


def _capsule_params(starts: np.ndarray, ends: np.ndarray):
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    segs = ends - starts
    lengths = np.linalg.norm(segs, axis=1)
    dirs = segs / lengths[:, None]
    return [
        (
            tuple(map(float, starts[e])),
            tuple(map(float, dirs[e])),
            float(lengths[e]),
        )
        for e in range(starts.shape[0])
    ]


def _axis_aligned_groups(starts: np.ndarray, ends: np.ndarray):
    """Group axis-aligned segments by (axis, start-along-axis, length).

    Returns ``None`` unless *every* segment is axis-aligned. Each group shares
    one clamped-projection computation; perpendicular offsets within a group
    reduce to cached squared coordinate differences.
    """
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    groups: dict = {}
    for s, e in zip(starts, ends):
        seg = e - s
        nz = np.nonzero(np.abs(seg) > 1e-12)[0]
        if len(nz) != 1:
            return None
        axis = int(nz[0])
        length = float(seg[axis])
        if length < 0:
            s, length = e, -length
        key = (axis, round(float(s[axis]), 9), round(length, 9))
        perp = tuple(
            (a, round(float(s[a]), 9)) for a in range(3) if a != axis
        )
        groups.setdefault(key, []).append(perp)
    return groups


def capsule_set_sq_csdf(starts: np.ndarray, ends: np.ndarray) -> CSdf:
    """*Squared* min distance to a static capsule-axis set.

    Two optimizations over the reference's per-edge ``sd_line`` loop
    (signed_distance.cu:93-113):

    * within a same-radius group ``min`` commutes with ``sqrt``, so the
      per-capsule transcendental collapses to one ``sqrt`` per group;
    * axis-aligned edges (every box skeleton) share their clamped axial
      projection per parallel-edge group, and the perpendicular squared
      offsets are cached per distinct coordinate — a 4-edge group costs
      ~24 ops instead of ~76.
    """
    groups = _axis_aligned_groups(starts, ends)

    if groups is not None:

        def f_aligned(x, y, z):
            coords = (x, y, z)
            sq_cache: dict = {}

            def sq_off(axis, value):
                key = (axis, value)
                if key not in sq_cache:
                    d = coords[axis] - value
                    sq_cache[key] = d * d
                return sq_cache[key]

            best = None
            for (axis, a0, length), perps in groups.items():
                r = coords[axis] - a0
                t = jnp.clip(r, 0.0, length)
                e = r - t
                axial = e * e
                # the c0/c1 corner loops are independent, so a group's perp
                # offsets always form a cross product V1 x V2; min over the
                # combos factorizes into axial + min(V1) + min(V2), provided
                # the two slots touch different axes
                s1 = sorted({p[0] for p in perps})
                s2 = sorted({p[1] for p in perps})
                axes1 = {a for a, _ in s1}
                axes2 = {a for a, _ in s2}
                if (
                    not (axes1 & axes2)
                    and len(s1) * len(s2) == len(set(perps))
                    and set(perps) == {(a, b) for a in s1 for b in s2}
                ):
                    m1 = sq_off(*s1[0])
                    for p in s1[1:]:
                        m1 = jnp.minimum(m1, sq_off(*p))
                    m2 = sq_off(*s2[0])
                    for p in s2[1:]:
                        m2 = jnp.minimum(m2, sq_off(*p))
                    d2 = axial + m1 + m2
                else:
                    d2 = None
                    for perp in perps:
                        c = axial + sq_off(*perp[0]) + sq_off(*perp[1])
                        d2 = c if d2 is None else jnp.minimum(d2, c)
                best = d2 if best is None else jnp.minimum(best, d2)
            return best

        return f_aligned

    params = _capsule_params(starts, ends)

    def f(x, y, z):
        best = None
        for (ax, ay, az), (ux, uy, uz), ln in params:
            rx, ry, rz = x - ax, y - ay, z - az
            t = jnp.clip(rx * ux + ry * uy + rz * uz, 0.0, ln)
            dx = rx - t * ux
            dy = ry - t * uy
            dz = rz - t * uz
            d2 = dx * dx + dy * dy + dz * dz
            best = d2 if best is None else jnp.minimum(best, d2)
        return best

    return f


def capsule_set_csdf(starts: np.ndarray, ends: np.ndarray, radius: float) -> CSdf:
    """Min distance to a static set of capsules (segments minus ``radius``)."""
    sq = capsule_set_sq_csdf(starts, ends)

    def f(x, y, z):
        return jnp.sqrt(sq(x, y, z)) - radius

    return f


def box_skeleton_csdf(center, size, line_width: float, *, reference_compat=True) -> CSdf:
    starts, ends = _box_skeleton_edges(center, size, reference_compat)
    return capsule_set_csdf(np.asarray(starts), np.asarray(ends), line_width)


def min_csdf(*fs: CSdf) -> CSdf:
    def f(x, y, z):
        ds = [g(x, y, z) for g in fs]
        out = ds[0]
        for d in ds[1:]:
            out = jnp.minimum(out, d)
        return out

    return f


def _object_transform(params):
    """Static (translation, rotation-matrix) of the object params, or
    ``None`` when the transform is the identity (the parity default)."""
    oc = np.asarray(params.get("object_center", (0.0, 0.0, 0.0)), np.float64)
    oq = np.asarray(params.get("object_rotation", (1.0, 0.0, 0.0, 0.0)), np.float64)
    if np.allclose(oc, 0.0) and np.allclose(oq, (1.0, 0.0, 0.0, 0.0)):
        return None
    oq = oq / np.linalg.norm(oq)
    w, x, y, z = oq
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return oc, rot


def reference_object_csdf(params, *, reference_compat: bool = True) -> CSdf:
    """Component form of sd_obj (cuda/modules/common.cu:222-226), including
    the framework's rigid object transform extension (models/scenes.py
    ``_object_space_c``) baked as static constants."""
    center = np.asarray(params["skeleton_center"], np.float64)
    size = np.asarray(params["skeleton_size"], np.float64)
    lw = float(params["skeleton_line_width"])
    r = float(params["sphere_radius"])
    k = float(params["smooth_k"])

    skel = box_skeleton_csdf(center, size, lw, reference_compat=reference_compat)
    sph = sphere_csdf(0.0, 0.0, 0.0, r)
    transform = _object_transform(params)

    def f(x, y, z):
        if transform is not None:
            (tx, ty, tz), rot = transform
            x, y, z = x - float(tx), y - float(ty), z - float(tz)
            # inverse rotation = R^T: columns of R applied as rows
            m = [[float(v) for v in row] for row in rot.T]
            x, y, z = (
                m[0][0] * x + m[0][1] * y + m[0][2] * z,
                m[1][0] * x + m[1][1] * y + m[1][2] * z,
                m[2][0] * x + m[2][1] * y + m[2][2] * z,
            )
        return smooth_min_c(skel(x, y, z), sph(x, y, z), k)

    return f


def reference_render_scene_csdf(
    params, *, bb_size: float = 5.0, reference_compat: bool = True
) -> CSdf:
    """Component form of sd_scene (cuda/modules/compute_render.cu:3-19)."""
    obj = reference_object_csdf(params, reference_compat=reference_compat)
    frame = box_skeleton_csdf(
        np.zeros(3), np.full(3, bb_size), 0.05, reference_compat=reference_compat
    )
    return min_csdf(obj, frame)


def _reference_object_bounds(p):
    """Conservative AABB of the CSG object (sd_obj) alone, from the *actual*
    edge geometry — in reference-compat mode the skeleton's misplaced edges
    (signed_distance.cu:101) extend far beyond the nominal box, so a
    size-derived bound would cull real geometry (caught by
    tests/test_pallas.py::TestCsdf::test_bounds_contain_surface)."""
    starts, ends = _box_skeleton_edges(
        np.asarray(p["skeleton_center"], np.float32),
        np.asarray(p["skeleton_size"], np.float32),
        reference_compat=True,
    )
    pts = np.concatenate([np.asarray(starts), np.asarray(ends)], axis=0)
    lw = float(p["skeleton_line_width"])
    r = float(p["sphere_radius"])
    slack = float(p["smooth_k"]) / 6.0 + 1e-3
    lo = np.minimum(pts.min(axis=0) - lw, -r) - slack
    hi = np.maximum(pts.max(axis=0) + lw, r) + slack
    transform = _object_transform(p)
    if transform is not None:
        # AABB of the rotated+translated object box
        (tx, ty, tz), rot = transform
        corners = np.array(
            [
                [(lo[0], hi[0])[i], (lo[1], hi[1])[j], (lo[2], hi[2])[k]]
                for i in (0, 1)
                for j in (0, 1)
                for k in (0, 1)
            ]
        )
        moved = corners @ rot.T + np.array([tx, ty, tz])
        lo, hi = moved.min(axis=0), moved.max(axis=0)
    return lo, hi


def scene_bounds(scene: Scene, params=None) -> tuple | None:
    """Conservative AABB containing the scene surface, as nested float tuples
    ``((lx,ly,lz),(hx,hy,hz), slack)`` — static input to the render kernel's
    BB-skip.

    The box includes the smooth-min under-estimation slack
    (``smooth_min(a,b,k) >= min(a,b) - k/6``) so the skip can never cull a ray
    that might collide; the third element carries the same per-scene SDF
    undershoot bound for the cull's *margin* math (``_slab_cull``), replacing
    its fixed 0.1 default which is unsound for smooth_k > 0.6 (advisor
    finding, round 2).
    """
    p = scene.params if params is None else params
    if getattr(scene, "spec", None) is not None:
        from bsdmg_tpu.models.compose import composed_bounds

        return composed_bounds(scene, p)
    if scene.name in ("reference_object", "reference_render_scene"):
        lo, hi = _reference_object_bounds(p)
        slack = float(p["smooth_k"]) / 6.0 + 1e-3
        if scene.name == "reference_render_scene":
            lo = np.minimum(lo, -2.5 - 0.05 - 1e-3)
            hi = np.maximum(hi, 2.5 + 0.05 + 1e-3)
        return (tuple(map(float, lo)), tuple(map(float, hi)), slack)
    if scene.name == "sphere":
        # exact SDFs: slack only needs to absorb float noise
        r = float(p["radius"]) + 1e-3
        return ((-r, -r, -r), (r, r, r), 1e-3)
    if scene.name == "box":
        half = np.asarray(p["size"], np.float64) / 2.0 + 1e-3
        return (tuple(map(float, -half)), tuple(map(float, half)), 1e-3)
    if scene.name == "mandelbulb":
        # the power-7 bulb lives within radius ~1.2 of the origin (escape
        # radius 2 scaled by 0.4), scaled by params. The distance estimator
        # underestimates by an unbounded factor near the set; keep the
        # conservative 0.1 slack that has always been used for it.
        r = 1.25 * float(p["scale"]) + 1e-3
        return ((-r, -r, -r), (r, r, r), 0.1)
    return None


def compile_scene_split(scene: Scene, params=None):
    """Split a scene into (far_csdf, near_bb) for per-tile specialization.

    ``near_bb`` bounds a *localized* component; ``far_csdf`` is the scene
    with that component removed. A render-kernel tile whose rays all miss
    the (inflated) ``near_bb`` slab can sphere-trace ``far_csdf`` alone:
    stepping by the far distance is the exact sphere trace of the far-only
    scene, and rays provably further than the collision threshold from the
    near component can neither hit it nor overstep it. For the reference
    render scene this cuts the per-step SDF cost roughly in half on the
    majority of non-sky tiles (the CSG object covers a fraction of the
    frame-wireframe's screen area).

    Returns ``None`` when the scene has no useful split.
    """
    p = scene.params if params is None else params
    if scene.name == "reference_render_scene":
        far = box_skeleton_csdf(
            np.zeros(3), np.full(3, 5.0), 0.05, reference_compat=True
        )
        lo, hi = _reference_object_bounds(p)
        slack = float(p["smooth_k"]) / 6.0 + 1e-3
        return far, (tuple(map(float, lo)), tuple(map(float, hi)), slack)
    return None


def compile_scene_csdf(scene: Scene, params=None) -> CSdf | None:
    """Lower a built-in scene to component form; ``None`` if unsupported
    (callers fall back to the pure-JAX tracer)."""
    p = scene.params if params is None else params
    if getattr(scene, "spec", None) is not None:
        from bsdmg_tpu.models.compose import composed_baked_csdf

        return composed_baked_csdf(scene, p)
    if scene.name == "reference_object":
        return reference_object_csdf(p)
    if scene.name == "reference_render_scene":
        return reference_render_scene_csdf(p)
    if scene.name == "sphere":
        return sphere_csdf(0.0, 0.0, 0.0, float(p["radius"]))
    if scene.name == "box":
        return box_csdf(np.zeros(3), np.asarray(p["size"]))
    if scene.name == "mandelbulb":
        from bsdmg_tpu.sdf.primitives import sd_mandelbulb_c

        s = float(p["scale"]) * 0.4

        def f(x, y, z):
            return sd_mandelbulb_c(x / s, y / s, z / s) * s

        return f
    if scene.name == "wrapped_object":
        obj = reference_object_csdf(p)
        cell = float(p["cell"])
        half = cell / 2.0

        def f(x, y, z):
            # wrap (signed_distance.cu:9-18) in component form
            wx = -half + jnp.mod(x + half, cell)
            wy = -half + jnp.mod(y + half, cell)
            wz = -half + jnp.mod(z + half, cell)
            return obj(wx, wy, wz)

        return f
    return None
