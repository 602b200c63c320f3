"""Headline benchmark: 1080p sphere-traced render of the reference scene,
plus side metrics for every other pipeline stage, all on the GPU.

Prints the device lines first, then ONE JSON line per completed stage (the
last line holds every key). ``{"metric", "value", "unit", "vs_baseline"}``
describe the 1080p render headline; the other keys:

- ``render_rays_per_s_2560x1440``: the resolution the reference was built
  for (src/renderer/mod.rs:10).
- ``render_rays_per_s_1920x1080_frames2``: two frames per dispatch.
- ``grad_rays_per_s``: forward+backward differentiable render, 512^2.
- ``refine_voxels_per_s``: one refine level at the 64^3 operating point.
- ``mc_voxels_per_s``: marching-cubes extraction at a ~66k-voxel field.
- ``grid_render_rays_per_s_512``: mesh-asset (baked 128^3 grid) render at
  512^2 through the CLI's renderer.

Baseline: the reference publishes no numbers (see BASELINE.md). Its implied
operating point is its render target: 2560x1440 at 60 Hz, i.e.
2560*1440*60 = 221.2 Mrays/s. ``vs_baseline`` is measured rays/s over that.

Timing is ``bsdmg_tpu/bench.py::_slope_time``; replacing it with
per-frame ``block_until_ready`` medians is open work (ROADMAP S0).
"""

from __future__ import annotations

import json

WIDTH, HEIGHT = 1920, 1080
BASELINE_RAYS_PER_S = 2560 * 1440 * 60.0  # implied reference operating point


def grid_render_rays_per_s(width: int = 512, height: int = 512) -> float:
    """Mesh-asset render throughput: bake a 128^3 grid of the reference
    object on the device and render it through the CLI's renderer."""
    import math

    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.bench import _slope_time
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.cli import _make_renderer
    from bsdmg_tpu.models.mesh_sdf import bake_reference_grid, grid_scene

    scene = grid_scene(bake_reference_grid(128))
    render = _make_renderer(scene)
    cam = look_at((5.0, 2.0, -5.0), (0.0, 0.0, 0.0), fov=math.pi / 4)
    o, d, cone = generate_rays(cam, (width, height), (width, height))

    @jax.jit
    def many(k):
        def body(i, acc):
            img = render(o + 1e-6 * i.astype(jnp.float32), d, cone)
            return acc + img.sum()

        return jax.lax.fori_loop(0, k, body, 0.0)

    sec = _slope_time(lambda k: float(many(jnp.int32(k))), k1=2, k2=8)
    return width * height / sec


def main() -> None:
    from bsdmg_tpu.bench import (
        benchmark_marching_cubes, benchmark_refine, benchmark_render,
        benchmark_render_grad,
    )
    from bsdmg_tpu.utils.device import device_info, print_device_lines, require_gpu

    require_gpu()
    print_device_lines()
    rays_per_s = benchmark_render(WIDTH, HEIGHT)["rays_per_s"]
    out = {
        "metric": f"render_rays_per_s_{WIDTH}x{HEIGHT}",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "device": device_info(),
    }
    print(json.dumps(out), flush=True)

    # a stage that fails fails the run: every key comes from the GPU or the
    # run reports nothing
    stages = [
        ("refine_voxels_per_s", lambda: benchmark_refine()["voxels_per_s"]),
        ("mc_voxels_per_s", lambda: benchmark_marching_cubes()["voxels_per_s"]),
        ("grad_rays_per_s", lambda: benchmark_render_grad()["rays_per_s"]),
        ("render_rays_per_s_2560x1440",
         lambda: benchmark_render(2560, 1440)["rays_per_s"]),
        ("render_rays_per_s_1920x1080_frames2",
         lambda: benchmark_render(WIDTH, HEIGHT, frames=2)["rays_per_s"]),
        ("grid_render_rays_per_s_512", grid_render_rays_per_s),
    ]
    for key, fn in stages:
        out[key] = round(fn(), 1)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
