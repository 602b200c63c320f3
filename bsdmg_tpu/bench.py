"""Benchmark harness: rays/s render, Mvoxels/s refine + marching cubes.

The reference has no benchmark suite; these are the operating points implied
by its workload constants (BASELINE.md): full-image sphere trace of the exact
reference scene, voxel refinement throughput, MC extraction throughput.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np


def _sync_time(fn, iters: int = 3, warmup: int = 2):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _slope_time(
    make_many, k1: int = 1, k2: int = 8, iters: int = 3, passes: int = 3
) -> float:
    """Per-iteration device time via a robust multi-point slope.

    ``make_many(k)`` must return a host float after executing the workload
    ``k`` times inside ONE dispatch (e.g. a jitted loop ending in a reduction
    pulled to the host). Taking the slope in k removes the fixed per-dispatch
    cost. A two-point slope moves with a single jittered dispatch at either
    endpoint, so this takes >= 3 k-points spanning [k1, k2], best-of-
    ``iters`` per point, Theil–Sen (median of all pairwise slopes) per pass,
    and the median over ``passes`` independent passes.
    """

    def best(k):
        b = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            make_many(k)
            b = min(b, time.perf_counter() - t0)
        return b

    make_many(k1)
    while True:
        km = (k1 + k2) // 2
        ks = sorted({k1, km, k2})
        for k in ks:
            make_many(k)  # warm every point (compile + transport)
        pass_slopes = []
        for _ in range(passes):
            t = {k: best(k) for k in ks}
            pair = [
                (t[b] - t[a]) / (b - a)
                for i, a in enumerate(ks)
                for b in ks[i + 1:]
            ]
            pass_slopes.append(_median(pair))
        slope = _median(pass_slopes)
        if slope > 0:
            return slope
        # timing jitter swallowed the workload delta; a negative/zero slope
        # would publish a bogus
        # (infinite) rate — widen the delta until it dominates, then fail
        # loudly if even a large multiple cannot beat the jitter
        if k2 - k1 >= 64:
            raise RuntimeError(
                f"non-positive slope {slope:.3e}s between k={k1} and k={k2}; "
                "timing jitter exceeded the workload delta"
            )
        k2 *= 2
        iters += 1


def benchmark_render(
    width: int = 1920,
    height: int = 1080,
    *,
    iters: int = 3,
    frames: int = 1,
) -> dict[str, Any]:
    """Rays/s of the reference-scene render at the given resolution, through
    the renderer the CLI serves it with (``cli._make_renderer``).

    ``frames`` > 1 renders that many independent frames per dispatch by
    stacking their rays along the rows of one image (one kernel launch
    covers all of them)."""
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.cli import _make_renderer
    from bsdmg_tpu.models import reference_render_scene

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (width, height), (1920.0, 1080.0))
    cone = jnp.broadcast_to(jnp.asarray(cone, jnp.float32), (height, width))
    render = _make_renderer(scene)

    def render_i(i):
        # distinct origin offsets so no two frames fold together
        o = jnp.concatenate(
            [origins + 1e-6 * (i * frames + j) for j in range(frames)]
        )
        d = jnp.concatenate([dirs] * frames)
        c = jnp.concatenate([cone] * frames)
        return render(o, d, c)

    # K dispatches' worth of frames per timed call (distinct origins so
    # nothing folds away), summed to a scalar pulled to the host
    @jax.jit
    def many(k):
        def body(i, acc):
            return acc + jnp.sum(render_i(i.astype(jnp.float32)))

        return jax.lax.fori_loop(0, k, body, jnp.float32(0))

    per_iter = _slope_time(lambda k: float(many(k)), k1=2, k2=8, iters=iters)
    per_frame = per_iter / frames
    return {
        "rays_per_s": width * height / per_frame,
        "seconds_per_frame": per_frame,
        "width": width,
        "height": height,
        "frames": frames,
    }


def render_step_stats(width: int = 1920, height: int = 1080) -> dict[str, Any]:
    """Measured step-count statistics of the reference-scene march.

    Replaces a hand-maintained ``avg_steps`` constant in the roofline
    (utils/profiling.py): marches the frame with the render kernel's slab
    cull and reports the per-ray mean, the mean of per-tile maxima over the
    kernel's pixel tiles (what a tile-synchronized march executes), and the
    max.
    """
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.config import MarchConfig
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.pallas.csdf import scene_bounds
    from bsdmg_tpu.ops.pallas.render_triton import TILE_H, TILE_W
    from bsdmg_tpu.ops.trace import bb_parts, march_planes, slab_cull

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (width, height), (1920.0, 1080.0))
    csdf = compile_scene_csdf(scene)
    lo, hi, slack = bb_parts(scene_bounds(scene))
    config = MarchConfig()

    @jax.jit
    def steps_plane(o, d, c):
        c = jnp.broadcast_to(c, o.shape[:-1])
        o3 = (o[..., 0], o[..., 1], o[..., 2])
        d3 = (d[..., 0], d[..., 1], d[..., 2])
        miss, t_exit = slab_cull(*o3, *d3, lo, hi, c, config, slack)
        _, steps, _ = march_planes(
            csdf, config, o3, d3, c, ~miss,
            t_stop=jnp.minimum(t_exit, config.depth_limit),
        )
        return steps

    s = np.asarray(steps_plane(origins, dirs, cone), np.float64)
    hp = (height // TILE_H) * TILE_H
    wp = (width // TILE_W) * TILE_W
    tiles = s[:hp, :wp].reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W)
    tile_max = tiles.max(axis=(1, 3))
    return {
        "mean_steps": float(s.mean()),
        "mean_tile_max_steps": float(tile_max.mean()),
        "max_steps": float(s.max()),
    }


def benchmark_refine(init_factor: int = 64, iters: int = 3):
    """Mvoxels/s of one refinement level over the reference object.

    Times the on-device refine kernel (8-corner sign test + compaction,
    bsdmg_tpu/ops/refine.py) with slope timing; the dynamic-capacity
    host sync of :func:`refine_field` is API convenience, not kernel cost.
    """
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import create_voxel_field
    from bsdmg_tpu.mesh.field import _refine_blocked_jit, _round_capacity
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.refine import _BLOCK_ROWS

    scene = reference_object()
    sdf = scene.bind()
    csdf = compile_scene_csdf(scene)
    cfg = MeshGenConfig(init_factor=init_factor)
    field = create_voxel_field(cfg)
    lowers, count = field.lowers, jnp.int32(field.count)
    size = jnp.float32(field.voxel_size)
    # the production path + caps refine_field would pick (mesh/field.py)
    nb = (8 * _round_capacity(field.count)) // _BLOCK_ROWS
    block_cap = max(64, -(-nb // 4))

    @jax.jit
    def many(k):
        # consume the compacted output too: summing only the count lets XLA
        # dead-code the entire compaction and over-report throughput
        def body(i, total):
            out, n_new, _, alive = _refine_blocked_jit(
                sdf, lowers + 1e-7 * i.astype(jnp.float32), count, size,
                csdf, block_cap, cfg.bb_min,
            )
            return (
                total + jnp.sum(out) + n_new.astype(jnp.float32)
                + alive.astype(jnp.float32)
            )

        return jax.lax.fori_loop(0, k, body, jnp.float32(0))

    per_call = _slope_time(lambda k: float(many(k)), k1=2, k2=10, iters=5)
    return {
        "voxels_per_s": field.count / per_call,
        "seconds": per_call,
        "input_voxels": field.count,
    }


def benchmark_marching_cubes(
    init_factor: int = 64, iters: int = 3, levels: int = 2
):
    """Mvoxels/s of marching-cubes extraction (incl. Newton projection).

    ``levels=2`` measures at a 256-res surface field (~66k voxels) — large
    enough that per-dispatch overhead is <5% of the call (at the old
    single-level 16.5k-voxel field the measurement was dispatch-bound and
    under-reported kernel throughput ~2x)."""
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import create_voxel_field, refine_field
    from bsdmg_tpu.mesh.pipeline import _extract
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.pallas import compile_scene_csdf

    scene = reference_object()
    sdf = scene.bind()
    csdf = compile_scene_csdf(scene)
    cfg = MeshGenConfig(init_factor=init_factor)
    field = create_voxel_field(cfg)
    for _ in range(levels):
        field = refine_field(sdf, field, cfg, csdf=csdf)
    voxel_size = jnp.float32(field.voxel_size)
    count = jnp.int32(field.count)

    @jax.jit
    def many(k):
        # consume every output: positions/normals would otherwise be
        # dead-coded (Newton projection + normals dropped from the measure)
        def body(i, acc):
            soup = _extract(
                sdf, field.lowers + 1e-7 * i.astype(jnp.float32), voxel_size,
                count, cfg, csdf,
            )
            return (
                acc + jnp.sum(soup.valid) + jnp.sum(soup.positions)
                + jnp.sum(soup.normals)
            )

        return jax.lax.fori_loop(0, k, body, jnp.float32(0))

    per_call = _slope_time(lambda k: float(many(k)), k1=4, k2=16, iters=5)
    return {
        "voxels_per_s": field.count / per_call,
        "seconds": per_call,
        "voxel_count": field.count,
    }


def benchmark_render_grad(width: int = 512, height: int = 512, iters: int = 3):
    """Backward-pass rays/s: gradient of an L2 image loss w.r.t. SDF params
    (the BASELINE "forward + backward kernels" operating point)."""
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.cam import generate_rays, look_at

    from bsdmg_tpu.models import reference_render_scene

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (width, height), (1920.0, 1080.0))
    target = jnp.zeros((height, width, 3), jnp.float32)

    # sky slab cull with a conservative param trust region (bounds at the
    # default params, inflated 25% — what a fit caller would pass)
    from bsdmg_tpu.ops.pallas.csdf import scene_bounds

    lo, hi, slack = scene_bounds(scene)
    bb = (tuple(v - 0.25 for v in lo), tuple(v + 0.25 for v in hi), slack)

    # optimize the reference object's five shape parameters (the
    # operating point; the motion-system transform params are not fit
    # targets and an identity transform would only add dead quaternion math
    # to every traced SDF eval)
    params = {
        k: v
        for k, v in scene.params.items()
        if k not in ("object_center", "object_rotation")
    }

    # the training-step path: jax.value_and_grad of the diff render
    from bsdmg_tpu.grad import render_loss_and_grad

    @jax.jit
    def many(k):
        def body(i, acc):
            loss, g = render_loss_and_grad(
                scene.sdf, params, target,
                origins + 1e-7 * i.astype(jnp.float32), dirs, cone,
                csdf=scene.csdf, bb=bb,
            )
            return (
                acc + loss
                + sum(jnp.sum(jnp.abs(v)) for v in jax.tree.leaves(g))
            )

        return jax.lax.fori_loop(0, k, body, jnp.float32(0))

    per_call = _slope_time(lambda k: float(many(k)), k1=2, k2=16, iters=5)
    return {
        "rays_per_s": width * height / per_call,
        "seconds_per_frame": per_call,
        "width": width,
        "height": height,
    }


def benchmark_scaling(width: int = 1920, height: int = 1080, iters: int = 3):
    """Multi-device scaling efficiency of the sharded forward render.

    Measures rays/s on the full device mesh vs a single device and reports
    ``efficiency = (rays_per_s_N / N) / rays_per_s_1`` — the BASELINE
    scaling-efficiency operating point (target >= 0.8 at N >= 2). With one
    device it reports N=1 / efficiency 1.0 (nothing to scale).
    """
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.cli import _make_sharded_renderer
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.parallel import make_mesh

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (width, height), (1920.0, 1080.0))

    def measure(devices):
        # the served path (render --sharded) over a mesh of these devices
        render = _make_sharded_renderer(scene, make_mesh(devices))

        @jax.jit
        def many(k):
            def body(i, acc):
                o = origins + 1e-6 * i.astype(jnp.float32)
                return acc + jnp.sum(render(o, dirs, cone))

            return jax.lax.fori_loop(0, k, body, jnp.float32(0))

        per_frame = _slope_time(lambda k: float(many(k)), k2=4, iters=iters)
        return width * height / per_frame

    devices = jax.devices()
    n = len(devices)
    if n == 1:
        single = measure(devices[:1])
        return {"devices": 1, "rays_per_s": single, "efficiency": 1.0}
    single = measure(devices[:1])
    full = measure(devices)
    return {
        "devices": n,
        "rays_per_s": full,
        "rays_per_s_single": single,
        "efficiency": (full / n) / single,
    }
