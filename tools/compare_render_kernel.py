"""Time the Triton render kernel against XLA's march on one GPU.

    python tools/compare_render_kernel.py

Renders the reference scene at 1920x1080 and 2560x1440 with the kernel
(``ops/pallas/render_triton.py``) and with ``ops.shade.render_image_c``,
taking the two in turns: per size, ``ROUNDS`` rounds of a ``FRAMES``-frame
median each, warm-up excluded, every frame ended with
``block_until_ready``. Prints the card's name and power limit beside the
numbers and one JSON line per size.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES, ROUNDS = 10, 3


def median_frame(render, args) -> float:
    ts = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        jax.block_until_ready(render(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> None:
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.pallas.csdf import compile_scene_split, scene_bounds
    from bsdmg_tpu.ops.pallas.render_triton import render_image_triton
    from bsdmg_tpu.ops.shade import render_image_c
    from bsdmg_tpu.utils.device import device_info, print_device_lines, require_gpu

    require_gpu()
    print_device_lines()
    scene = reference_render_scene()
    csdf, bb = compile_scene_csdf(scene), scene_bounds(scene)
    split = compile_scene_split(scene)
    kernel = jax.jit(lambda o, d, c: render_image_triton(csdf, o, d, c, bb=bb, split=split))
    xla = jax.jit(lambda o, d, c: render_image_c(scene.csdf, scene.params, o, d, c))
    cam = look_at((5.0, 2.0, -5.0), fov=math.pi / 4)
    for w, h in ((1920, 1080), (2560, 1440)):
        o, d, c = generate_rays(cam, (w, h), (1920.0, 1080.0))
        c = jnp.broadcast_to(c, (h, w))
        if (w, h) == (2560, 1440):
            print(kernel.lower(o, d, c).compile().memory_analysis())
        for fn in (kernel, xla):  # warm-up: compile and first run
            jax.block_until_ready(fn(o, d, c))
        times = {"kernel": [], "xla": []}
        for r in range(ROUNDS):
            order = ("kernel", "xla") if r % 2 == 0 else ("xla", "kernel")
            for name in order:
                times[name].append(median_frame(kernel if name == "kernel" else xla,
                                                (o, d, c)))
        print(json.dumps({
            "size": f"{w}x{h}", "device": device_info(),
            "kernel_ms": [t * 1e3 for t in times["kernel"]],
            "xla_ms": [t * 1e3 for t in times["xla"]],
            "kernel_median_ms": float(np.median(times["kernel"])) * 1e3,
            "xla_median_ms": float(np.median(times["xla"])) * 1e3,
        }), flush=True)


if __name__ == "__main__":
    main()
