"""Smoke run of the whole system on one NVIDIA GPU (``--four``: the sharded
paths on four).

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: sharded render, train step, mesh

One process; every phase goes through the CLI's own code paths at full size
and is checked against the repository's plain references, and the first
failed check ends the run with a non-zero exit. Without a GPU it exits
non-zero before any phase. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``. Times
printed along the way are information, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CAMERA = ((5.0, 2.0, -5.0), (0.0, 0.0, 0.0))  # the CLI's default view
SCREEN = (1920.0, 1080.0)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def rays(width: int, height: int):
    from bsdmg_tpu.cam import generate_rays, look_at

    cam = look_at(*CAMERA, fov=math.pi / 4)
    return generate_rays(cam, (width, height), SCREEN)


def agreement(img, ref):
    """(share of pixels within 2e-2 on every channel, mean abs difference)."""
    diff = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    return float((diff.max(-1) < 2e-2).mean()), float(diff.mean())


def frame_times(render, args, n: int = 10):
    """(first call incl. compile, median of ``n`` steady frames) in seconds."""
    t0 = time.perf_counter()
    jax.block_until_ready(render(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(render(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def points_render(scene):
    """The plain AoS points path (ops/shade.py::render_image over
    ops/trace.py::sphere_trace), at full float32 matmul precision."""
    from bsdmg_tpu.ops.shade import render_image

    fn = jax.jit(lambda o, d, c: render_image(scene.bind(), o, d, c))

    def run(o, d, c):
        with jax.default_matmul_precision("highest"):
            return fn(o, d, c)

    return run


def phase_render() -> None:
    from bsdmg_tpu.cli import _get_scene, _make_renderer

    print("phase: analytic render", flush=True)
    cases = [("reference_render_scene", 2560, 1440)] + [
        (os.path.join(HERE, "examples", f"{n}.json"), 1920, 1080)
        for n in ("snowman", "gadget", "mushroom")
    ]
    for name, w, h in cases:
        scene = _get_scene(name)
        render = _make_renderer(scene)
        o, d, c = rays(w, h)
        first, med = frame_times(render, (o, d, c))
        img = render(o, d, c)
        ref = points_render(scene)(o, d, c)
        check(img.shape == o.shape and bool(jnp.isfinite(img).all()),
              f"{os.path.basename(name)} {w}x{h}: finite frame of shape {img.shape}")
        near, mean = agreement(img, ref)
        print(f"  {os.path.basename(name)} {w}x{h}: compile + first call {first:.3f} s, "
              f"median frame {med * 1e3:.3f} ms; vs points path: "
              f"{near:.6f} within 2e-2, mean {mean:.3e}", flush=True)
        check(near >= 0.995 and mean < 1e-3,
              f"{os.path.basename(name)} matches the points path")

    golden = np.load(os.path.join(HERE, "tests", "golden", "render_256x144.npz"))["image"]
    img = _make_renderer(_get_scene("reference_render_scene"))(*rays(256, 144))
    near, mean = agreement(img, golden)
    print(f"  256x144 vs NumPy oracle: {near:.6f} within 2e-2, mean {mean:.3e}")
    check(near >= 0.99 and mean < 2e-3, "256x144 matches the NumPy oracle")


def mesh_levels(scene, refine, newton_iters):
    """The CLI's mesh job (cmd_mesh): returns (voxel count per level, mesh)."""
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import generate_mesh
    from bsdmg_tpu.ops.pallas import compile_scene_csdf

    counts = []
    mesh = generate_mesh(
        scene.bind(), refine_steps=refine,
        config=MeshGenConfig(newton_iters=newton_iters),
        on_level=lambda f: counts.append(int(f.count)),
        csdf=compile_scene_csdf(scene),
    )
    return counts, mesh


def phase_mesh() -> None:
    from bsdmg_tpu.mesh.export import load_obj, save_obj
    from bsdmg_tpu.models import reference_object

    print("phase: mesh job (refine 5: 32^3 -> 1024^3, MC, Newton, weld, OBJ)",
          flush=True)
    # the native weld/OBJ library is built here from the committed sources
    subprocess.run(["make", "-B", "-C", os.path.join(HERE, "native")],
                   check=True, capture_output=True)
    from bsdmg_tpu.runtime.native import native_available

    check(native_available(), "native weld/OBJ library built and loaded")
    scene = reference_object()
    t0 = time.perf_counter()
    counts, mesh = mesh_levels(scene, 5, 8)
    took = time.perf_counter() - t0
    print(f"  voxels per level: {counts}; {mesh.vertex_count} vertices, "
          f"{mesh.triangle_count} triangles in {took:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.obj")
        save_obj(mesh, path)
        back = load_obj(path)
    check(back.vertex_count == mesh.vertex_count
          and back.triangle_count == mesh.triangle_count,
          "OBJ written and read back whole")
    with jax.default_device(jax.devices("cpu")[0]):
        sd = np.abs(np.asarray(scene.bind()(jnp.asarray(mesh.vertices, jnp.float32))))
    print(f"  max |sdf| over welded vertices: {sd.max():.3e}")
    check(mesh.triangle_count > 1_000_000, "over a million triangles at 1024^3")
    check(sd.max() <= 1e-5, "every welded vertex within 1e-5 of the surface")

    gpu_counts, _ = mesh_levels(scene, 3, 8)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_counts, _ = mesh_levels(scene, 3, 8)
    print(f"  refine 3 voxels per level: card {gpu_counts}, CPU {cpu_counts}")
    check(len(gpu_counts) == len(cpu_counts) and all(
        abs(a - b) <= 1e-3 * b for a, b in zip(gpu_counts, cpu_counts)),
        "refine-3 level counts within 0.1% of the CPU run")


def phase_fit() -> None:
    from bsdmg_tpu.cli import build_parser, cmd_fit
    from bsdmg_tpu.grad import differentiable_hit
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.trace import COLLISION

    print("phase: inverse-rendering fit (cli fit, 512x512, 20 steps)", flush=True)
    args = build_parser().parse_args(
        ["fit", "--width", "512", "--height", "512", "--steps", "20"]
    )
    t0 = time.perf_counter()
    res = cmd_fit(args)
    print(f"  loss {res.losses[0]:.4e} -> {res.losses[-1]:.4e} in "
          f"{time.perf_counter() - t0:.1f} s")
    check(res.losses[-1] < 0.5 * res.losses[0], "the loss falls")
    for k, true in res.true_params.items():
        true, start, got = (float(np.asarray(v)) for v in
                            (true, res.start[k], res.params[k]))
        print(f"  {k}: {start:.4f} -> {got:.4f} (true {true:.4f})")
        check(abs(got - true) < abs(start - true), f"{k} moves toward the truth")

    # step-0 gradient vs central differences at 128x128, on pixels whose
    # outcome holds under +-eps (tests/test_grad.py: rel 0.1, abs 2e-3)
    scene = reference_object()
    o, d, c = rays(128, 128)
    params = dict(scene.params)
    params["sphere_radius"] = params["sphere_radius"] * 1.3
    params["smooth_k"] = params["smooth_k"] * 0.6
    target, _ = differentiable_hit(scene.sdf, scene.params, o, d, c)
    eps = 1e-3

    def hit(p):
        return differentiable_hit(scene.sdf, p, o, d, c)[1].outcome == COLLISION

    mask = hit(params)
    for k in ("sphere_radius", "smooth_k"):
        for sgn in (1.0, -1.0):
            q = dict(params)
            q[k] = params[k] + sgn * eps
            mask = mask & hit(q)
    mask = mask & hit(scene.params)

    @jax.jit
    def loss(p):
        t, _ = differentiable_hit(scene.sdf, p, o, d, c)
        return jnp.sum(jnp.where(mask, (t - target) ** 2, 0.0)) / jnp.sum(mask)

    g = jax.grad(loss)(params)
    for k in ("sphere_radius", "smooth_k"):
        pp, pm = dict(params), dict(params)
        pp[k] = params[k] + eps
        pm[k] = params[k] - eps
        fd = (float(loss(pp)) - float(loss(pm))) / (2 * eps)
        ad = float(g[k])
        print(f"  d loss / d {k}: AD {ad:.5e}, FD {fd:.5e}")
        check(abs(ad - fd) <= 2e-3 + 0.1 * abs(fd), f"{k} gradient matches FD")


def phase_grid() -> None:
    from bsdmg_tpu.cli import _make_renderer
    from bsdmg_tpu.models.mesh_sdf import SdfGrid, bake_reference_grid, grid_scene

    print("phase: mesh-asset render (128^3 grid baked on the card)", flush=True)
    grid = bake_reference_grid(128)
    render = _make_renderer(grid_scene(grid))
    o, d, c = rays(1920, 1080)
    first, med = frame_times(render, (o, d, c))
    img = render(o, d, c)
    print(f"  1920x1080: compile + first call {first:.3f} s, median frame {med * 1e3:.3f} ms")
    check(bool(jnp.isfinite(img).all()) and float(img.max()) > 0,
          "finite, non-empty 1920x1080 frame")
    small = rays(256, 256)
    on_card = np.asarray(render(*small))
    with jax.default_device(jax.devices("cpu")[0]):
        host = SdfGrid(values=np.asarray(grid.values), lo=grid.lo, hi=grid.hi)
        on_cpu = np.asarray(_make_renderer(grid_scene(host))(
            *(jnp.asarray(np.asarray(x)) for x in small)))
    near, mean = agreement(on_card, on_cpu)
    print(f"  256x256 vs CPU: {near:.6f} within 2e-2, mean {mean:.3e}")
    check(near >= 0.99, "256x256 matches the CPU backend")


def phase_four() -> None:
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bsdmg_tpu.cli import _get_scene, _make_renderer, _make_sharded_renderer
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import generate_mesh
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.parallel import generate_mesh_sharded, make_mesh, shard_rays, train_step

    check(len(jax.devices()) == 4, f"{len(jax.devices())} GPUs visible, 4 needed")
    print("phase: sharded render 2560x1440 (render --sharded)", flush=True)
    scene = _get_scene("reference_render_scene")
    o, d, c = rays(2560, 1440)
    one = _make_renderer(scene)(o, d, c)
    sharded = _make_sharded_renderer(scene)
    first, med = frame_times(sharded, (o, d, c))
    four = sharded(o, d, c)
    near, mean = agreement(four, one)
    print(f"  4 cards: compile + first call {first:.3f} s, median frame {med * 1e3:.3f} ms; "
          f"vs one card {near:.6f} within 2e-2, mean {mean:.3e}")
    check(near >= 0.995 and mean < 1e-3, "sharded frame matches one card")

    print("phase: sharded train step", flush=True)
    params = {k: v for k, v in scene.params.items()
              if k not in ("object_center", "object_rotation")}
    o2, d2, c2 = rays(512, 256)
    target = jnp.asarray(
        np.random.default_rng(0).uniform(0, 1, o2.shape), jnp.float32
    )
    opt = optax.adam(1e-2)

    def step(mesh):
        so, sd_, sc, _ = shard_rays(o2, d2, c2, mesh, interleave=False)
        tgt = jax.device_put(target, NamedSharding(mesh, P("dp", "sp")))
        p = jax.tree.map(lambda v: jnp.array(v, jnp.float32), params)
        new, _, loss = train_step(scene.sdf, p, opt.init(p), opt, tgt, so, sd_, sc,
                                  mesh, csdf=scene.csdf)
        return float(loss), {k: np.asarray(v) for k, v in new.items()}

    loss1, p1 = step(make_mesh(jax.devices()[:1], shape=(1, 1)))
    for shape in ((4, 1), (2, 2)):
        lossn, pn = step(make_mesh(shape=shape))
        print(f"  mesh {shape}: loss {lossn:.8e} vs one device {loss1:.8e}")
        check(abs(lossn - loss1) <= 1e-4 * abs(loss1)
              and all(np.allclose(pn[k], p1[k], rtol=1e-4, atol=0) for k in p1),
              f"mesh {shape}: loss and updated params within rtol 1e-4")

    print("phase: sharded mesh generation (refine 4)", flush=True)
    obj = reference_object()
    cfg = MeshGenConfig(newton_iters=8)
    csdf = compile_scene_csdf(obj)
    single = generate_mesh(obj.bind(), refine_steps=4, config=cfg, csdf=csdf)
    sharded = generate_mesh_sharded(obj.bind(), make_mesh(), refine_steps=4,
                                    config=cfg, csdf=csdf)
    print(f"  welded vertices: one card {single.vertex_count}, "
          f"four {sharded.vertex_count}")
    check(single.vertex_count == sharded.vertex_count,
          "same welded vertex count")
    a, b = np.asarray(single.vertices), np.asarray(sharded.vertices)
    a, b = a[np.lexsort(a.T)], b[np.lexsort(b.T)]
    check(float(np.abs(a - b).max()) <= 1e-5, "vertices within 1e-5")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the sharded paths on four GPUs, nothing else")
    args = parser.parse_args()

    from bsdmg_tpu.utils.device import device_info, print_device_lines, require_gpu

    require_gpu()
    print_device_lines()
    if args.four:
        phase_four()
    else:
        check(len(jax.devices()) >= 1, "a GPU is visible")
        phase_render()
        phase_mesh()
        phase_fit()
        phase_grid()
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
