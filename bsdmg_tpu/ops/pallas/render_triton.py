"""GPU render kernel: slab cull -> per-tile march -> fused shade.

One Pallas program (through Triton) per ``TILE_H x TILE_W`` pixel tile —
the reference's 128-thread block over 8x16 pixels (compute_render.cu:21-97,
SURVEY §1). Each program:

1. **Slab cull.** Collisions satisfy ``f <= cone*t + eps`` and can only
   happen inside the scene box inflated by ``cone*T*`` (``ops.trace.
   slab_cull``), so rays that miss it never march, and its exit depth is a
   sound per-ray stop. Tiles whose rays all miss the *near* component's
   inflated slab march a cheaper far-only scene (``compile_scene_split``).
2. **March.** ``ops.trace.march_planes`` on the tile: the march state stays
   in registers and the program exits when its own tile has resolved, not
   when the frame's slowest ray has.
3. **Shade.** fd4 normals (12 SDF evals, skipped for collision-free tiles),
   Lambert mix and ACES run before the tile's one store of r, g, b.

The scene is a param-baked component SDF (``compile_scene_csdf``): every
constant is a Python float the kernel inlines.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.ops.shade import shade_planes
from bsdmg_tpu.ops.trace import COLLISION, bb_parts, march_planes, slab_cull
from bsdmg_tpu.sdf.normals import normal_fd4_c

#: Pixel tile of one program: 128 pixels on 4 warps, one pixel a thread.
TILE_H, TILE_W = 8, 16
NUM_WARPS = 4


def _tile_kernel(csdf, config: MarchConfig, bb, split):
    def kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, cone_ref,
               r_ref, g_ref, b_ref):
        o = (ox_ref[...], oy_ref[...], oz_ref[...])
        d = (dx_ref[...], dy_ref[...], dz_ref[...])
        cone = cone_ref[...]

        active0 = t_stop = None
        if bb is not None:
            lo, hi, slack = bb_parts(bb)
            miss, t_exit = slab_cull(*o, *d, lo, hi, cone, config, slack)
            active0 = ~miss
            t_stop = jnp.minimum(t_exit, config.depth_limit)

        def render(scene):
            depth, _, outcome = march_planes(
                scene, config, o, d, cone, active0, t_stop=t_stop
            )

            def lit(_):
                p = [o[a] + depth * d[a] for a in range(3)]
                n = normal_fd4_c(scene, *p, config.normal_epsilon)
                return shade_planes(*n, outcome)

            def unlit(_):
                # no collision in the tile: white on step-limit, black else
                zero = jnp.zeros_like(depth)
                return shade_planes(zero, zero, zero, outcome)

            any_hit = jnp.sum((outcome == COLLISION).astype(jnp.int32)) > 0
            return jax.lax.cond(any_hit, lit, unlit, None)

        if split is None:
            rgb = render(csdf)
        else:
            # per-tile scene specialization: a tile whose rays all stay more
            # than the collision threshold from the near component's slab
            # traces the far scene alone — the exact trace of the only
            # surface those rays can reach
            far, nbb = split
            nlo, nhi, nslack = bb_parts(nbb)
            n_miss, _ = slab_cull(*o, *d, nlo, nhi, cone, config, nslack)
            near = ~n_miss if active0 is None else active0 & ~n_miss
            any_near = jnp.sum(near.astype(jnp.int32)) > 0
            rgb = jax.lax.cond(
                any_near, lambda _: render(csdf), lambda _: render(far), None
            )
        r_ref[...], g_ref[...], b_ref[...] = rgb

    return kernel


def _pad(plane, hp, wp, value):
    h, w = plane.shape
    return jnp.pad(plane, ((0, hp - h), (0, wp - w)), constant_values=value)


@functools.partial(
    jax.jit, static_argnames=("csdf", "config", "bb", "split", "interpret")
)
def render_image_triton(
    csdf: Callable,
    origins: jax.Array,
    directions: jax.Array,
    cone_radius,
    config: MarchConfig = MarchConfig(),
    *,
    bb: tuple | None = None,
    split=None,
    interpret: bool = False,
) -> jax.Array:
    """Render an ``(H, W)`` ray image with the tile kernel; linear RGB
    ``(H, W, 3)``, the same semantics as ``ops.shade.render_image_c``.

    ``bb`` (``csdf.scene_bounds``) turns on the slab cull, ``split``
    (``csdf.compile_scene_split``) the per-tile scene specialization.
    Ragged sizes are padded to whole tiles with rays that start far outside
    the scene. ``interpret`` runs the kernel in the Pallas interpreter
    (tests on a machine without a GPU)."""
    h, w = origins.shape[:2]
    hp = -(-h // TILE_H) * TILE_H
    wp = -(-w // TILE_W) * TILE_W
    cone = jnp.broadcast_to(jnp.asarray(cone_radius, jnp.float32), (h, w))
    planes = (
        [_pad(origins[..., a], hp, wp, 1e5) for a in range(3)]
        + [_pad(directions[..., a], hp, wp, 1.0 if a == 0 else 0.0)
           for a in range(3)]
        + [_pad(cone, hp, wp, 0.0)]
    )
    spec = pl.BlockSpec((TILE_H, TILE_W), lambda i, j: (i, j))
    plane = jax.ShapeDtypeStruct((hp, wp), jnp.float32)
    r, g, b = pl.pallas_call(
        _tile_kernel(csdf, config, bb, split),
        grid=(hp // TILE_H, wp // TILE_W),
        in_specs=[spec] * 7,
        out_specs=[spec] * 3,
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="render_tile",
    )(*planes)
    return jnp.stack([r[:h, :w], g[:h, :w], b[:h, :w]], axis=-1)
