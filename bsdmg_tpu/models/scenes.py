"""Built-in scenes, including the reference's exact CSG object.

Reference geometry:

* ``sd_obj`` (cuda/modules/common.cu:222-226): ``smooth_min`` of a box
  skeleton (center 0, size (3, 1, 0.5), line width 0.1) and a sphere of
  radius 1, smoothing k = 0.5.
* ``sd_scene`` (cuda/modules/compute_render.cu:3-19): ``sd_obj`` unioned with
  the mesh-generation bounding-box wireframe (size 5, line width 0.05).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from bsdmg_tpu.sdf import primitives as sdf

Params = Any
SceneFn = Callable[[Params, jax.Array], jax.Array]
SceneCFn = Callable[..., jax.Array]  # (params, x, y, z) -> d


@dataclasses.dataclass(frozen=True)
class Scene:
    """A differentiable SDF scene: ``sdf(params, p)`` plus default params.

    ``csdf``, when present, is the component-form twin ``f(params, x, y, z)``
    operating on coordinate planes — differentiable w.r.t. ``params`` (see
    bsdmg_tpu/sdf/primitives.py SoA section).
    Distinct from ``ops.pallas.compile_scene_csdf``, which bakes params as
    compile-time constants for the non-differentiable render kernel.
    """

    name: str
    sdf: SceneFn
    params: Params
    csdf: SceneCFn | None = None
    #: composed-scene spec tree (models/compose.py) — present only on scenes
    #: built by ``compose_scene``; lets ops/pallas/csdf.py bake the tree for
    #: the render kernel and derive slab-cull bounds
    spec: Any | None = None
    #: baked SdfGrid (models/mesh_sdf.py) — present only on mesh-asset scenes
    grid: Any | None = None

    def bind(self, params: Params | None = None) -> Callable[[jax.Array], jax.Array]:
        """Close over ``params`` (default params if None) for APIs that want
        a plain ``p -> distance`` function."""
        bound = self.params if params is None else params
        scene_fn = self.sdf
        return lambda p: scene_fn(bound, p)


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# The reference CSG object
# ---------------------------------------------------------------------------


def default_object_params() -> dict:
    """Parameters of the reference's hard-coded object (common.cu:222-226).

    ``object_center``/``object_rotation`` are this framework's extension: a
    rigid transform of the whole object, driven per frame by the motion
    system (``models.motion.apply_motion`` = src/example_scene.rs:120-154 —
    in the reference, motion components move Bevy *entities*; here the SDF
    object itself is the entity, so motion enters through these params).
    The defaults are the exact identity, so all reference-parity paths are
    bit-identical."""
    return {
        "skeleton_center": _f32([0.0, 0.0, 0.0]),
        "skeleton_size": _f32([3.0, 1.0, 0.5]),
        "skeleton_line_width": _f32(0.1),
        "sphere_radius": _f32(1.0),
        "smooth_k": _f32(0.5),
        "object_center": _f32([0.0, 0.0, 0.0]),
        "object_rotation": _f32([1.0, 0.0, 0.0, 0.0]),  # quat (w, x, y, z)
    }


def _quat_inv_rotate_c(q, x, y, z):
    """Rotate coordinate planes by the *inverse* of quaternion ``q`` (w,x,y,z).

    Normalizes ``q`` first so optimizer/FD perturbations off the unit sphere
    still denote a pure rotation. With the identity quat the rotation matrix
    is exactly I in float32, so default params cost nothing numerically."""
    if not isinstance(q, (tuple, list)):
        q = (q[0], q[1], q[2], q[3])
    inv = jax.lax.rsqrt(
        jnp.maximum(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-24)
    )
    w, qx, qy, qz = q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv
    # rows of R(q); inverse rotation applies R^T, i.e. columns
    r00, r01, r02 = 1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)
    r10, r11, r12 = 2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)
    r20, r21, r22 = 2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)
    return (
        r00 * x + r10 * y + r20 * z,
        r01 * x + r11 * y + r21 * z,
        r02 * x + r12 * y + r22 * z,
    )


def _object_space_c(params: dict, x, y, z):
    """Map world coordinate planes into the object's local frame."""
    oc = params.get("object_center")
    if oc is not None:
        x, y, z = x - oc[0], y - oc[1], z - oc[2]
    oq = params.get("object_rotation")
    if oq is not None:
        x, y, z = _quat_inv_rotate_c(oq, x, y, z)
    return x, y, z


def _sd_obj_c(params: dict, x, y, z, *, reference_compat: bool = True) -> jax.Array:
    x, y, z = _object_space_c(params, x, y, z)
    a1 = sdf.sd_box_skeleton_c(
        x, y, z,
        params["skeleton_center"],
        params["skeleton_size"],
        params["skeleton_line_width"],
        reference_compat=reference_compat,
    )
    # the reference's sphere is pinned at the origin (common.cu:224)
    a2 = sdf.sd_sphere_c(x, y, z, (0.0, 0.0, 0.0), params["sphere_radius"])
    return sdf.smooth_min(a1, a2, params["smooth_k"])


def _sd_obj(params: dict, p: jax.Array, *, reference_compat: bool = True) -> jax.Array:
    x, y, z = _object_space_c(params, p[..., 0], p[..., 1], p[..., 2])
    p = jnp.stack([x, y, z], axis=-1)
    a1 = sdf.sd_box_skeleton(
        p,
        params["skeleton_center"],
        params["skeleton_size"],
        params["skeleton_line_width"],
        reference_compat=reference_compat,
    )
    a2 = sdf.sd_sphere(p, jnp.zeros(3, jnp.float32), params["sphere_radius"])
    return sdf.smooth_min(a1, a2, params["smooth_k"])


def reference_object(*, reference_compat: bool = True) -> Scene:
    """The mesh-generation target object ``sd_obj``."""
    fn = lambda params, p: _sd_obj(params, p, reference_compat=reference_compat)
    cfn = lambda params, x, y, z: _sd_obj_c(
        params, x, y, z, reference_compat=reference_compat
    )
    return Scene("reference_object", fn, default_object_params(), cfn)


def reference_render_scene(
    *, bb_size: float = 5.0, reference_compat: bool = True
) -> Scene:
    """The render scene: object + bounding-box wireframe (compute_render.cu:3-19)."""

    def fn(params: dict, p: jax.Array) -> jax.Array:
        sd = _sd_obj(params, p, reference_compat=reference_compat)
        frame = sdf.sd_box_skeleton(
            p,
            jnp.zeros(3, jnp.float32),
            jnp.full((3,), bb_size, jnp.float32),
            0.05,
            reference_compat=reference_compat,
        )
        return jnp.minimum(sd, frame)

    def cfn(params: dict, x, y, z) -> jax.Array:
        sd = _sd_obj_c(params, x, y, z, reference_compat=reference_compat)
        frame = sdf.sd_box_skeleton_c(
            x, y, z,
            jnp.zeros(3, jnp.float32),
            jnp.full((3,), bb_size, jnp.float32),
            0.05,
            reference_compat=reference_compat,
        )
        return jnp.minimum(sd, frame)

    return Scene("reference_render_scene", fn, default_object_params(), cfn)


# ---------------------------------------------------------------------------
# Additional scenes
# ---------------------------------------------------------------------------


def sphere_scene(radius: float = 1.0) -> Scene:
    params = {"radius": _f32(radius)}
    return Scene(
        "sphere",
        lambda q, p: sdf.sd_sphere(p, 0.0, q["radius"]),
        params,
        lambda q, x, y, z: sdf.sd_sphere_c(x, y, z, 0.0, q["radius"]),
    )


def box_scene(size=(1.0, 1.0, 1.0)) -> Scene:
    params = {"size": _f32(size)}
    return Scene("box", lambda q, p: sdf.sd_box(p, 0.0, q["size"]), params)


def mandelbulb_scene(scale: float = 1.0) -> Scene:
    """Power-7 mandelbulb (signed_distance.cu:29-57)."""
    params = {"scale": _f32(scale)}

    def fn(q, p):
        s = q["scale"] * 0.4
        return sdf.sd_mandelbulb(p / s) * s

    def cfn(q, x, y, z):
        s = q["scale"] * 0.4
        return sdf.sd_mandelbulb_c(x / s, y / s, z / s) * s

    return Scene("mandelbulb", fn, params, cfn)


def wrapped_object_scene(cell: float = 8.0) -> Scene:
    """The reference object repeated infinitely on a cubic lattice via the
    ``wrap`` domain-repetition primitive (signed_distance.cu:9-18 — the
    reference ships ``wrap`` but never wires it into a scene; this scene
    gives it a product path). ``cell`` is the lattice period; the wrapped
    value is a correct distance *bound* as long as the object (extent ~3.5)
    stays well inside the cell, which sphere tracing requires anyway."""
    params = dict(default_object_params())
    params["cell"] = _f32(cell)

    def cfn(q, x, y, z):
        half = q["cell"] / 2.0
        wx = -half + jnp.mod(x + half, q["cell"])
        wy = -half + jnp.mod(y + half, q["cell"])
        wz = -half + jnp.mod(z + half, q["cell"])
        return _sd_obj_c(q, wx, wy, wz)

    def fn_wrapped(q, p):
        half = q["cell"] / 2.0
        wrapped = sdf.wrap(p, jnp.full(3, -half), jnp.full(3, half))
        return _sd_obj(q, wrapped)

    return Scene("wrapped_object", fn_wrapped, params, cfn)


SCENES: dict[str, Callable[[], Scene]] = {
    "reference_object": reference_object,
    "reference_render_scene": reference_render_scene,
    "sphere": sphere_scene,
    "box": box_scene,
    "mandelbulb": mandelbulb_scene,
    "wrapped_object": wrapped_object_scene,
}


def get_scene(name: str, **kwargs) -> Scene:
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name](**kwargs)
