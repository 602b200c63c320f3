"""Scene animation: the reference's motion components as pure functions.

JAX equivalent of the reference's Bevy motion system
(src/example_scene.rs:63-160): three motion components —
:class:`RotateAxisMotion`, :class:`SphericCyclicMotion`,
:class:`AxisCyclicMotion` — plus :func:`apply_motion` which advances a set of
transforms to time ``t``. Where Bevy mutates ``Transform`` components every
frame, here motion is a pure function ``t -> Transform`` (jit/vmap-friendly:
evaluate a whole animation's worth of timestamps in one call), and
``set_center`` becomes the ``center=None -> captured from the initial
transform`` rule applied at construction (src/example_scene.rs:103-118).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


@dataclasses.dataclass(frozen=True)
class Transform:
    """Translation + quaternion rotation (w, x, y, z)."""

    translation: jax.Array
    rotation: jax.Array

    @staticmethod
    def identity() -> "Transform":
        return Transform(
            jnp.zeros(3, jnp.float32),
            jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32),
        )

    @staticmethod
    def from_translation(v) -> "Transform":
        return Transform(
            jnp.asarray(v, jnp.float32),
            jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32),
        )


def quat_from_axis_angle(axis, angle) -> jax.Array:
    axis = jnp.asarray(axis, jnp.float32)
    axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-12)
    half = jnp.asarray(angle, jnp.float32) * 0.5
    return jnp.concatenate(
        [jnp.cos(half)[None], jnp.sin(half) * axis]
    )


@dataclasses.dataclass(frozen=True)
class RotateAxisMotion:
    """Continuous rotation about ``axis``, one turn per ``cycle_duration``
    (src/example_scene.rs:63-67, rotation arm :145-150)."""

    axis: Sequence[float] = (0.0, 1.0, 0.0)
    cycle_duration: float = 5.0

    def rotation_at(self, t) -> jax.Array:
        angle = TWO_PI * (jnp.asarray(t, jnp.float32) / self.cycle_duration)
        return quat_from_axis_angle(self.axis, angle)


@dataclasses.dataclass(frozen=True)
class SphericCyclicMotion:
    """Per-axis sinusoidal offsets with independent periods
    (src/example_scene.rs:69-84, arm :136-141)."""

    center: Optional[Sequence[float]] = None  # None: captured by set_center
    distances: Sequence[float] = (1.0, 1.0, 1.0)
    cycle_durations: Sequence[float] = (5.0, 5.0, 5.0)

    def translation_at(self, t) -> jax.Array:
        c = jnp.zeros(3) if self.center is None else jnp.asarray(self.center)
        d = TWO_PI * jnp.asarray(t, jnp.float32) / jnp.asarray(
            self.cycle_durations, jnp.float32
        )
        return c + jnp.asarray(self.distances, jnp.float32) * jnp.sin(d)


@dataclasses.dataclass(frozen=True)
class AxisCyclicMotion:
    """Sinusoidal oscillation along ``direction``
    (src/example_scene.rs:86-101, arm :129-135)."""

    center: Optional[Sequence[float]] = None
    direction: Sequence[float] = (0.0, 1.0, 0.0)
    cycle_duration: float = 5.0

    def translation_at(self, t) -> jax.Array:
        c = jnp.zeros(3) if self.center is None else jnp.asarray(self.center)
        phase = TWO_PI * jnp.asarray(t, jnp.float32) / self.cycle_duration
        return c + jnp.asarray(self.direction, jnp.float32) * jnp.sin(phase)


def set_center(motion, transform: Transform):
    """Fill a cyclic motion's ``center`` from the entity's initial transform
    if unset — the reference's ``Added<...>`` startup system
    (src/example_scene.rs:103-118)."""
    if isinstance(motion, (SphericCyclicMotion, AxisCyclicMotion)):
        if motion.center is None:
            return dataclasses.replace(
                motion, center=tuple(float(v) for v in jnp.asarray(transform.translation))
            )
    return motion


def apply_motion(
    transform: Transform,
    t,
    *,
    axis_cyclic: Optional[AxisCyclicMotion] = None,
    spheric_cyclic: Optional[SphericCyclicMotion] = None,
    rotate_axis: Optional[RotateAxisMotion] = None,
    enable_movement: bool = True,
) -> Transform:
    """Advance one entity's transform to time ``t``.

    Matches the reference's precedence exactly (src/example_scene.rs:120-154):
    axis-cyclic wins over spheric-cyclic for translation; rotation composes
    independently; everything is gated by ``enable_movement``
    (``ExampleSceneSettings``, src/example_scene.rs:156-160).
    """
    if not enable_movement:
        return transform
    translation = transform.translation
    rotation = transform.rotation
    if axis_cyclic is not None:
        translation = axis_cyclic.translation_at(t)
    elif spheric_cyclic is not None:
        translation = spheric_cyclic.translation_at(t)
    if rotate_axis is not None:
        rotation = rotate_axis.rotation_at(t)
    return Transform(translation, rotation)


@dataclasses.dataclass(frozen=True)
class SceneSettings:
    """The reference's ``ExampleSceneSettings`` (src/example_scene.rs:156-160)."""

    enable_movement: bool = False


def motion_params(
    params: dict,
    t,
    *,
    axis_cyclic: Optional[AxisCyclicMotion] = None,
    spheric_cyclic: Optional[SphericCyclicMotion] = None,
    rotate_axis: Optional[RotateAxisMotion] = None,
    enable_movement: bool = True,
) -> dict:
    """Scene params at time ``t`` with the object's rigid transform driven
    by the motion components.

    The reference's ``apply_motion`` mutates an entity ``Transform``
    (src/example_scene.rs:120-154); here the SDF object *is* the entity, so
    the advanced transform lands in the ``object_center``/``object_rotation``
    params consumed by ``models.scenes._object_space_c``. Same precedence
    (axis-cyclic over spheric-cyclic; rotation composes independently) and
    the same ``enable_movement`` gate."""
    base = Transform(
        jnp.asarray(params.get("object_center", jnp.zeros(3)), jnp.float32),
        jnp.asarray(
            params.get("object_rotation", jnp.asarray([1.0, 0.0, 0.0, 0.0])),
            jnp.float32,
        ),
    )
    moved = apply_motion(
        base,
        t,
        axis_cyclic=axis_cyclic,
        spheric_cyclic=spheric_cyclic,
        rotate_axis=rotate_axis,
        enable_movement=enable_movement,
    )
    out = dict(params)
    out["object_center"] = moved.translation
    out["object_rotation"] = moved.rotation
    return out
