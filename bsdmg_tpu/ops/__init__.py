"""Compute ops: sphere tracing, shading, voxel refinement, marching cubes.

Each op has a pure-JAX implementation (the correctness oracle, runs
anywhere); the render hot path adds a Pallas (Triton) GPU kernel
(``ops/pallas/render_triton.py``).
"""

from bsdmg_tpu.ops.trace import (
    COLLISION,
    DEPTH_LIMIT,
    STEP_LIMIT,
    RayMarchHit,
    sphere_trace,
)
from bsdmg_tpu.ops.shade import aces_tonemap, render_image, shade_hits, to_rgba8

__all__ = [
    "COLLISION",
    "DEPTH_LIMIT",
    "STEP_LIMIT",
    "RayMarchHit",
    "sphere_trace",
    "aces_tonemap",
    "render_image",
    "shade_hits",
    "to_rgba8",
]
