"""Command-line interface — the headless app shell.

The reference app is an interactive Bevy window (fly camera, B to refine,
V to advance the Empty -> VoxelField -> Mesh state machine, OBJ save;
src/input_handling.rs:6-44, src/renderer/mod.rs:155-226) plus a HEADLESS env
mode that, as committed, fires all events in one frame and therefore never
actually refines (src/main.rs:20-34 — see SURVEY §3.5).

This CLI is the real version of that surface:

* ``render``  — sphere-trace a scene to PNG/NPY (the per-frame hot path)
* ``mesh``    — create field, refine k times, extract, weld, save OBJ/VTK
  (the intended headless sequence: advance -> refine^k -> advance -> save)
* ``animate`` — render a camera orbit (the fly-camera analogue)
* ``bench``   — rays/s + Mvoxels/s operating points
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import NamedTuple

import numpy as np


def _add_scene_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--scene",
        default="reference_render_scene",
        help="scene name (bsdmg_tpu.models.SCENES), 'mesh:path.obj[:RES]' "
        "for an OBJ asset, or a .json CSG spec (models/compose.py)",
    )


def _parse_mesh_spec(rest: str, default_resolution: int = 128):
    """Split ``path.obj[:RES]`` into (path, resolution). The suffix is only
    treated as a resolution when it parses as an integer — OBJ paths may
    legitimately contain colons."""
    resolution = default_resolution
    if ":" in rest:
        head, _, res_s = rest.rpartition(":")
        try:
            resolution = int(res_s)
            rest = head
        except ValueError:
            pass
    return rest, resolution


def _get_scene(name: str):
    """Resolve a scene name. ``mesh:path.obj[:RES]`` loads a triangle-mesh
    asset and bakes it into a grid SDF scene (the reference ships OBJ assets
    loadable via bevy_obj but unused by any code path, src/main.rs:65 —
    here they are first-class render/mesh targets)."""
    if name.startswith("mesh:"):
        rest, resolution = _parse_mesh_spec(name[len("mesh:"):])
        from bsdmg_tpu.mesh.export import load_obj
        from bsdmg_tpu.models.mesh_sdf import mesh_scene

        src = load_obj(rest)
        scene, _ = mesh_scene(src.vertices, src.faces, resolution=resolution)
        return scene
    if name.startswith("spec:") or name.endswith(".json"):
        # composed scene from a JSON CSG spec (models/compose.py) — the
        # data-driven counterpart of the reference's compiled-in sd_obj
        from bsdmg_tpu.models.compose import load_scene_spec

        return load_scene_spec(name[len("spec:"):] if name.startswith("spec:") else name)
    from bsdmg_tpu.models import get_scene

    return get_scene(name)


def _camera(args):
    from bsdmg_tpu.cam import look_at

    return look_at(
        tuple(args.camera), tuple(args.target), fov=args.fov
    )


def _kernel_scene(scene):
    """``(csdf, bb, split)`` for the Triton tile kernel, or ``None`` where it
    does not serve: ``backend.use_render_kernel()`` says no, or the scene
    has no param-baked component form (grid-SDF mesh assets)."""
    from bsdmg_tpu.backend import use_render_kernel
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.pallas.csdf import compile_scene_split, scene_bounds

    if not use_render_kernel():
        return None
    csdf = compile_scene_csdf(scene)
    if csdf is None:
        return None
    return csdf, scene_bounds(scene), compile_scene_split(scene)


def _make_renderer(scene):
    """Build a reusable ``(origins, dirs, cone) -> image`` callable: the
    Triton tile kernel where :func:`_kernel_scene` allows it, the XLA
    component-form march (``render_image_c``) for any other scene with a
    component form (grid-SDF mesh assets included), the points path
    otherwise. Build ONCE per scene — the jit caches key on the scene
    closure's identity, so a new closure per frame recompiles."""
    import jax

    from bsdmg_tpu.ops.shade import render_image, render_image_c

    baked = _kernel_scene(scene)
    if baked is not None:
        from bsdmg_tpu.ops.pallas.render_triton import render_image_triton

        csdf, bb, split = baked
        return lambda o, d, c: render_image_triton(csdf, o, d, c, bb=bb, split=split)
    if scene.csdf is not None:
        params = scene.params
        cfn = scene.csdf
        return jax.jit(lambda o, d, c: render_image_c(cfn, params, o, d, c))
    sdf = scene.bind()
    return jax.jit(lambda o, d, c: render_image(sdf, o, d, c))


def _make_sharded_renderer(scene, dev_mesh=None):
    """Multi-device counterpart of :func:`_make_renderer` over ``dev_mesh``
    (default: every local device): the tile kernel under ``shard_map`` where
    the single-device renderer would use it, the sharded XLA march otherwise
    (mesh assets included). Build ONCE per scene, for the same reason."""
    from bsdmg_tpu.parallel import make_mesh
    from bsdmg_tpu.parallel.sharding import render_sharded, render_sharded_kernel

    dev_mesh = make_mesh() if dev_mesh is None else dev_mesh
    baked = _kernel_scene(scene)
    if baked is not None:
        csdf, bb, split = baked
        return lambda o, d, c: render_sharded_kernel(
            csdf, o, d, c, dev_mesh, bb=bb, split=split
        )
    return lambda o, d, c: render_sharded(
        scene.sdf, scene.params, o, d, c, dev_mesh, csdf=scene.csdf
    )


def cmd_render(args) -> None:
    import jax

    from bsdmg_tpu.cam import generate_rays
    from bsdmg_tpu.mesh.export import save_png
    from bsdmg_tpu.ops.shade import to_rgba8
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    scene = _get_scene(args.scene)
    cam = _camera(args)
    origins, dirs, cone = generate_rays(
        cam, (args.width, args.height), (args.screen_width, args.screen_height)
    )
    t0 = time.perf_counter()
    if getattr(args, "sharded", False):
        img = jax.block_until_ready(
            _make_sharded_renderer(scene)(origins, dirs, cone)
        )
        log.info("sharded render over %d device(s)", len(jax.devices()))
    else:
        img = jax.block_until_ready(_make_renderer(scene)(origins, dirs, cone))
    log.info(
        "rendered %dx%d in %.3fs (incl. compile)",
        args.width,
        args.height,
        time.perf_counter() - t0,
    )
    out = args.output or "render.png"
    if out.endswith(".npy"):
        np.save(out, np.asarray(img))
    else:
        save_png(np.asarray(to_rgba8(img)), out)
    log.info("wrote %s", out)


def cmd_mesh(args) -> None:
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import generate_mesh
    from bsdmg_tpu.mesh.export import save_field, save_obj, save_vtk
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    scene_name = args.scene if args.scene != "reference_render_scene" else "reference_object"
    scene = _get_scene(scene_name)
    cfg = MeshGenConfig(
        init_factor=args.init_factor,
        bb_size=args.bb_size,
        newton_iters=args.newton_iters,
        interpolate_edges=args.interpolate_edges,
    )

    def on_level(field):
        log.info(
            "level %d: %d voxels of size %.5f",
            field.level,
            field.count,
            field.voxel_size,
        )
        if args.checkpoint:
            save_field(field, f"{args.checkpoint}.L{field.level}.npz")

    from bsdmg_tpu.ops.pallas import compile_scene_csdf

    t0 = time.perf_counter()
    if args.sharded:
        # multi-device pipeline: shard-local refine + extraction over every
        # local device (parallel/mesh.py); identical welded vertex set
        from bsdmg_tpu.parallel import generate_mesh_sharded, make_mesh

        dev_mesh = make_mesh()
        log.info("sharded pipeline over %d device(s)", dev_mesh.devices.size)
        mesh = generate_mesh_sharded(
            scene.bind(), dev_mesh, refine_steps=args.refine, config=cfg,
            csdf=compile_scene_csdf(scene),
        )
    elif args.resume:
        # deterministic recovery (SURVEY §5): restart the pipeline from a
        # saved field snapshot instead of level 0
        from bsdmg_tpu.mesh import refine_field
        from bsdmg_tpu.mesh.export import load_field
        from bsdmg_tpu.mesh.pipeline import extract_mesh_chunked

        csdf = compile_scene_csdf(scene)
        field = load_field(args.resume)
        log.info(
            "resumed from %s: level %d, %d voxels", args.resume, field.level, field.count
        )
        on_level(field)
        for _ in range(args.refine):
            field = refine_field(scene.bind(), field, cfg, csdf=csdf)
            on_level(field)
        mesh = extract_mesh_chunked(scene.bind(), field, cfg, csdf=csdf)
    else:
        mesh = generate_mesh(
            scene.bind(), refine_steps=args.refine, config=cfg, on_level=on_level,
            csdf=compile_scene_csdf(scene),
        )
    log.info(
        "mesh: %d vertices, %d triangles in %.3fs",
        mesh.vertex_count,
        mesh.triangle_count,
        time.perf_counter() - t0,
    )
    out = args.output or "generated_mesh.obj"
    if out.endswith(".vtk"):
        save_vtk(mesh, out)
    else:
        save_obj(mesh, out)
    log.info("wrote %s", out)


def _motion_components(args):
    """Motion components from CLI flags, mirroring the reference's optional
    per-entity components (src/example_scene.rs:63-101)."""
    from bsdmg_tpu.models.motion import (
        AxisCyclicMotion,
        RotateAxisMotion,
        SphericCyclicMotion,
    )

    axis_cyclic = spheric_cyclic = rotate_axis = None
    if args.motion == "axis":
        axis_cyclic = AxisCyclicMotion(cycle_duration=args.cycle_duration)
    elif args.motion == "spheric":
        spheric_cyclic = SphericCyclicMotion(
            cycle_durations=(args.cycle_duration,) * 3
        )
    if args.rotate:
        rotate_axis = RotateAxisMotion(cycle_duration=args.cycle_duration)
    return axis_cyclic, spheric_cyclic, rotate_axis


def cmd_animate(args) -> None:
    import jax

    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.mesh.export import save_png
    from bsdmg_tpu.ops.shade import to_rgba8
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    scene = _get_scene(args.scene)

    axis_cyclic, spheric_cyclic, rotate_axis = _motion_components(args)
    moving = (
        axis_cyclic is not None
        or spheric_cyclic is not None
        or rotate_axis is not None
    )
    if moving and scene.csdf is None:
        log.warning("scene %s has no param-traced form; motion ignored", scene.name)
        moving = False
    if moving and not isinstance(scene.params, dict):
        log.warning("scene %s params carry no rigid transform; motion ignored", scene.name)
        moving = False
    # composed scenes whose root is a `transform` node take motion through
    # that node's offset/rotation params (the n0_* keys); map the motion
    # system's object_center/object_rotation onto them
    motion_keys = ("object_center", "object_rotation")
    if (
        moving
        and "object_center" not in scene.params
        and scene.spec is not None
        and scene.spec["root"].get("op") == "transform"
    ):
        motion_keys = ("n0_offset", "n0_rotation")
    elif moving and "object_center" not in scene.params:
        # grid-SDF mesh scenes bake geometry into the table; their csdf
        # ignores the transform params motion_params would write. Composed
        # scenes without a root transform node have nowhere to put a rigid
        # transform either — suggest the wrapper.
        hint = (
            " (wrap the spec root in {'op': 'transform', 'child': ...} "
            "to animate it)" if scene.spec is not None else ""
        )
        log.warning(
            "scene %s does not consume object_center/object_rotation; "
            "motion ignored%s", scene.name, hint,
        )
        moving = False

    if moving:
        # object motion enters through params, so the frame loop re-uses one
        # param-traced jit (no per-frame recompile) instead of the baked kernel
        from bsdmg_tpu.models.motion import motion_params
        from bsdmg_tpu.ops.shade import render_image_c

        render_p = jax.jit(
            lambda p, o, d, c: render_image_c(scene.csdf, p, o, d, c)
        )
    else:
        render = _make_renderer(scene)

    radius = float(np.linalg.norm(args.camera))
    gif_frames = [] if getattr(args, "gif", None) else None
    for i in range(args.frames):
        t = args.seconds * i / max(args.frames, 1)
        if moving:
            # camera holds still so the object's motion is what animates
            pos = tuple(args.camera)
        else:
            theta = 2 * math.pi * i / args.frames
            pos = (radius * math.cos(theta), args.camera[1], radius * math.sin(theta))
        cam = look_at(pos, tuple(args.target), fov=args.fov)
        origins, dirs, cone = generate_rays(
            cam, (args.width, args.height), (args.screen_width, args.screen_height)
        )
        if moving:
            if motion_keys[0] == "object_center":
                view = scene.params
            else:
                view = {
                    "object_center": scene.params[motion_keys[0]],
                    "object_rotation": scene.params[motion_keys[1]],
                }
            moved = motion_params(
                view,
                t,
                axis_cyclic=axis_cyclic,
                spheric_cyclic=spheric_cyclic,
                rotate_axis=rotate_axis,
                enable_movement=args.enable_movement,
            )
            if motion_keys[0] == "object_center":
                p_t = moved
            else:
                p_t = dict(scene.params)
                p_t[motion_keys[0]] = moved["object_center"]
                p_t[motion_keys[1]] = moved["object_rotation"]
            img = jax.block_until_ready(render_p(p_t, origins, dirs, cone))
        else:
            img = jax.block_until_ready(render(origins, dirs, cone))
        rgba8 = np.asarray(to_rgba8(img))
        path = f"{args.output or 'frame'}_{i:04d}.png"
        save_png(rgba8, path)
        if gif_frames is not None:
            gif_frames.append(rgba8)
        log.info("frame %d/%d (t=%.2fs) -> %s", i + 1, args.frames, t, path)
    if gif_frames is not None:
        from bsdmg_tpu.mesh.export import save_gif

        fps = args.frames / args.seconds if args.seconds > 0 else 10.0
        save_gif(gif_frames, args.gif, fps=fps)
        log.info("wrote %s (%d frames, %.1f fps)", args.gif, args.frames, fps)


def cmd_remesh(args) -> None:
    """Load a mesh asset, bake a grid SDF, re-extract at target resolution."""
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import generate_mesh
    from bsdmg_tpu.mesh.export import load_obj, save_obj, save_vtk
    from bsdmg_tpu.models.mesh_sdf import bake_mesh_grid, grid_sdf
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    src = load_obj(args.input)
    log.info("loaded %s: %d verts, %d tris", args.input, src.vertex_count, src.triangle_count)
    t0 = time.perf_counter()
    grid = bake_mesh_grid(src.vertices, src.faces, resolution=args.grid_resolution)
    log.info("baked %d^3 SDF grid in %.2fs", args.grid_resolution, time.perf_counter() - t0)
    sdf = grid_sdf(grid)

    bb_size = float(grid.hi[0] - grid.lo[0])
    cfg = MeshGenConfig(
        init_factor=args.init_factor, bb_size=bb_size, newton_iters=args.newton_iters
    )
    # the grid is centered; shift the field by the grid center
    import jax.numpy as jnp

    from bsdmg_tpu.models.mesh_sdf import grid_csdf

    center = jnp.asarray([(l + h) / 2 for l, h in zip(grid.lo, grid.hi)], jnp.float32)
    shifted = lambda p: sdf(p + center)
    gcsdf = grid_csdf(grid)
    shifted_c = lambda x, y, z: gcsdf(x + center[0], y + center[1], z + center[2])
    mesh = generate_mesh(shifted, refine_steps=args.refine, config=cfg, csdf=shifted_c)
    mesh.vertices = mesh.vertices + np.asarray(center)
    log.info("remeshed: %d verts, %d tris", mesh.vertex_count, mesh.triangle_count)
    out = args.output or "remeshed.obj"
    (save_vtk if out.endswith(".vtk") else save_obj)(mesh, out)
    log.info("wrote %s", out)


def _parse_perturb(spec: str) -> dict[str, tuple[str, float]]:
    """Parse ``key=factor,key=+delta`` into ``{key: (mode, value)}``.

    A plain number (or ``*number``) multiplies the true param; ``+number``
    adds to it — the way to perturb zero-valued params (centers, offsets),
    where a factor would silently change nothing."""
    out: dict[str, tuple[str, float]] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition("=")
        val = val.strip()
        mode = "mul"
        if val.startswith("+"):
            mode, val = "add", val[1:]
        elif val.startswith("*"):
            val = val[1:]
        try:
            out[key.strip()] = (mode, float(val))
        except ValueError:
            raise SystemExit(
                f"--perturb: expected key=factor or key=+delta, got {item!r}"
            ) from None
    if not out:
        raise SystemExit("--perturb: no key=factor pairs found")
    return out


def _apply_perturb(params: dict, perturb: dict) -> dict:
    """Perturb ``params`` per ``_parse_perturb``'s spec; refuses no-ops."""
    import numpy as _np

    out = dict(params)
    for key, (mode, value) in perturb.items():
        out[key] = out[key] + value if mode == "add" else out[key] * value
        if _np.allclose(_np.asarray(out[key]), _np.asarray(params[key])):
            raise SystemExit(
                f"--perturb: {key} is unchanged by the perturbation "
                f"({mode} {value}) — for zero-valued params use key=+delta"
            )
    return out


class FitResult(NamedTuple):
    """What a fit did: the loss at every step, and the perturbed params at
    the start, at the end and their true values."""

    losses: list
    start: dict
    params: dict
    true_params: dict


def cmd_fit(args) -> FitResult:
    """Inverse rendering: recover SDF parameters from a target depth map
    (default) or from a target *image* (``--image``).

    Works for ANY differentiable scene — built-ins or composed JSON specs
    (models/compose.py): the target is synthesized at the scene's true
    params, the listed ``--perturb key=factor`` params are perturbed, and
    gradient descent recovers them."""
    import jax
    import jax.numpy as jnp

    from bsdmg_tpu.cam import generate_rays
    from bsdmg_tpu.grad import differentiable_hit
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.ops.trace import COLLISION
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    default_scene = args.scene == "reference_render_scene"
    scene = reference_object() if default_scene else _get_scene(args.scene)
    if not isinstance(scene.params, dict) or not scene.params:
        raise SystemExit(f"scene {scene.name!r} has no fittable parameters")
    cam = _camera(args)
    origins, dirs, cone = generate_rays(
        cam, (args.width, args.height), (args.screen_width, args.screen_height)
    )

    if args.perturb:
        perturb = _parse_perturb(args.perturb)
    elif default_scene:
        perturb = (
            {"sphere_radius": ("mul", 1.25), "smooth_k": ("mul", 0.7),
             "skeleton_line_width": ("mul", 1.3)}
            if args.image
            else {"sphere_radius": ("mul", 1.3), "smooth_k": ("mul", 0.6)}
        )
    else:
        raise SystemExit(
            f"pass --perturb key=factor[,key=+delta] to pick which of "
            f"{sorted(scene.params)} to perturb and recover"
        )
    unknown = set(perturb) - set(scene.params)
    if unknown:
        raise SystemExit(
            f"--perturb keys {sorted(unknown)} not in scene params "
            f"{sorted(scene.params)}"
        )

    if args.image:
        return _fit_image(args, log, origins, dirs, cone, scene, perturb, default_scene)

    watched = sorted(perturb)

    # synthesize a target from the true params, then perturb and recover
    t_target, hit_t = differentiable_hit(scene.sdf, scene.params, origins, dirs, cone)
    t_target = jax.lax.stop_gradient(t_target)
    params = _apply_perturb(scene.params, perturb)
    start = {k: params[k] for k in watched}

    stable0 = hit_t.outcome == COLLISION

    @jax.jit
    def loss_fn(p):
        t, hit = differentiable_hit(scene.sdf, p, origins, dirs, cone)
        mask = stable0 & (hit.outcome == COLLISION)
        err = (t - t_target) * mask
        return jnp.sum(err**2) / jnp.maximum(jnp.sum(mask), 1)

    def fmt(p):
        return " ".join(
            f"{k}={np.asarray(p[k]).ravel().round(4).tolist()}" for k in watched
        )

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for i in range(args.steps):
        loss, g = grad_fn(params)
        params = jax.tree.map(lambda p, gg: p - args.lr * gg, params, g)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            log.info("step %d: loss=%.3e %s", i, losses[-1], fmt(params))
    log.info("recovered %s (true %s)", fmt(params), fmt(scene.params))
    return FitResult(
        losses, start, {k: params[k] for k in watched},
        {k: scene.params[k] for k in watched},
    )


def _fit_image(args, log, origins, dirs, cone, scene, perturb, default_scene) -> FitResult:
    """Image-loss inverse rendering: render a target at the true params,
    perturb, recover by gradient descent. Each step is
    ``render_loss_and_grad``.

    For the default scene this is a JOINT fit of sphere radius (+25%),
    smooth_k (-30%) and skeleton line width (+30%); any other scene
    (including composed JSON specs) fits whatever ``--perturb`` names.
    Large perturbations flip ray outcomes, which pure IFT gradients cannot
    see (step discontinuities — SURVEY §7 hard-part 3); the
    silhouette-aware closest-approach loss (grad/edge.py, ``edge_weight``)
    supplies the missing boundary gradients, extending the round-2 ±6%
    basin to beyond ±25%."""
    import jax
    import optax

    from bsdmg_tpu.grad import render_image_diff, render_loss_and_grad
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.ops.pallas.csdf import scene_bounds

    if scene.csdf is None:
        raise SystemExit(
            f"fit --image needs a param-traced component SDF; scene "
            f"{scene.name!r} has none"
        )
    if default_scene:
        scene = reference_render_scene()
        true_params = {
            k: v
            for k, v in scene.params.items()
            if k not in ("object_center", "object_rotation")
        }
    else:
        true_params = dict(scene.params)

    # bounds over the whole optimization's param range: inflate by a
    # conservative trust region when available
    bounds = scene_bounds(scene)
    bb = None
    if bounds is not None:
        lo, hi, slack = bounds
        bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)

    target = jax.lax.stop_gradient(
        render_image_diff(
            scene.sdf, true_params, origins, dirs, cone, csdf=scene.csdf, bb=bb
        )
    )
    params = _apply_perturb(true_params, perturb)
    watched = sorted(perturb)
    start = {k: params[k] for k in watched}

    def fmt(p):
        return " ".join(
            f"{k}={np.asarray(p[k]).ravel().round(4).tolist()}" for k in watched
        )

    step = jax.jit(
        lambda p: render_loss_and_grad(
            scene.sdf, p, target, origins, dirs, cone,
            csdf=scene.csdf, bb=bb, edge_weight=1.0,
        )
    )
    opt = optax.adam(args.lr * 0.1)
    opt_state = opt.init(params)
    losses = []
    for i in range(args.steps):
        loss, g = step(params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            log.info("step %d: loss=%.3e %s", i, losses[-1], fmt(params))
    log.info("recovered %s (true %s)", fmt(params), fmt(true_params))
    return FitResult(
        losses, start, {k: params[k] for k in watched},
        {k: true_params[k] for k in watched},
    )


def cmd_session(args) -> None:
    """Drive the interactive stage machine with a scripted key sequence.

    The reference binds B -> refine and V -> advance (src/input_handling.rs:
    37-42); ``--keys vbbbvv`` (or ``--commands advance,refine,...``) replays
    the same sequence headlessly — the working version of the reference's
    broken HEADLESS mode (src/main.rs:20-34, see SURVEY §3.5).
    """
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import MeshGenSession
    from bsdmg_tpu.utils import get_logger

    log = get_logger()
    scene = _get_scene(args.scene)
    cfg = MeshGenConfig(init_factor=args.init_factor, bb_size=args.bb_size)
    from bsdmg_tpu.ops.pallas import compile_scene_csdf

    session = MeshGenSession(
        scene.bind(), cfg, output_path=args.output or "generated_mesh.obj",
        csdf=compile_scene_csdf(scene),
    )
    if args.commands:
        steps = [c.strip() for c in args.commands.split(",") if c.strip()]
        bad = [s for s in steps if s not in ("refine", "advance")]
        if bad:
            build_parser().error(
                f"--commands accepts only 'refine'/'advance', got: {', '.join(bad)}"
            )
    else:
        names = {"b": "refine", "v": "advance"}
        steps = [names[k] for k in args.keys.lower() if k in names]
    for step in steps:
        log.info("session step: %s (stage=%s)", step, session.stage.value)
        getattr(session, step)()
    log.info("final stage: %s", session.stage.value)


def cmd_bench(args) -> None:
    import contextlib

    from bsdmg_tpu.bench import (
        benchmark_marching_cubes,
        benchmark_refine,
        benchmark_render,
    )

    # --trace: capture a jax.profiler xplane around the benched region —
    # the app-level analogue of the reference's cuProfilerStart + nvtx
    # scoping (src/main.rs:37, src/cuda/mod.rs:354-370)
    ctx = contextlib.nullcontext()
    if args.trace:
        from bsdmg_tpu.utils.profiling import trace

        ctx = trace(args.trace)

    results = {}
    with ctx:
        if args.which in ("all", "render"):
            r = benchmark_render(args.width, args.height)
            results["render"] = {
                "rays_per_s": r["rays_per_s"],
                "ms_per_frame": r["seconds_per_frame"] * 1e3,
            }
            if args.roofline:
                from bsdmg_tpu.bench import render_step_stats
                from bsdmg_tpu.utils.profiling import render_roofline

                stats = render_step_stats(args.width, args.height)
                roof = render_roofline(
                    args.width, args.height,
                    avg_steps=stats["mean_tile_max_steps"],
                )
                results["roofline"] = {
                    **stats,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": 100.0
                    * roof.efficiency(r["seconds_per_frame"]),
                }
        if args.which in ("all", "refine"):
            r = benchmark_refine()
            results["refine"] = {"voxels_per_s": r["voxels_per_s"]}
            if args.roofline:
                from bsdmg_tpu.models import reference_object
                from bsdmg_tpu.ops.pallas import compile_scene_csdf
                from bsdmg_tpu.utils.profiling import (
                    csdf_flops_per_eval, refine_roofline,
                )

                ops = csdf_flops_per_eval(
                    compile_scene_csdf(reference_object())
                )
                roof = refine_roofline(r["input_voxels"], ops_per_eval=ops)
                results["refine_roofline"] = {
                    "ops_per_eval": ops,
                    "evals_per_parent": 27,
                    "bound": roof.bound,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": 100.0 * roof.efficiency(r["seconds"]),
                }
        if args.which in ("all", "mc"):
            r = benchmark_marching_cubes()
            results["marching_cubes"] = {"voxels_per_s": r["voxels_per_s"]}
        if args.which in ("all", "grad"):
            from bsdmg_tpu.bench import benchmark_render_grad

            r = benchmark_render_grad()
            results["render_grad"] = {"rays_per_s": r["rays_per_s"]}
        if args.which == "scaling":
            from bsdmg_tpu.bench import benchmark_scaling

            results["scaling"] = benchmark_scaling(args.width, args.height)
    if args.trace:
        results["trace_dir"] = args.trace
    print(json.dumps(results, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bsdmg", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common_camera(sp):
        sp.add_argument("--camera", type=float, nargs=3, default=[5.0, 2.0, -5.0])
        sp.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
        sp.add_argument("--fov", type=float, default=math.pi / 4)
        sp.add_argument("--width", type=int, default=1920)
        sp.add_argument("--height", type=int, default=1080)
        sp.add_argument("--screen-width", type=float, default=1920.0)
        sp.add_argument("--screen-height", type=float, default=1080.0)

    r = sub.add_parser("render", help="sphere-trace a scene to PNG/NPY")
    _add_scene_arg(r)
    common_camera(r)
    r.add_argument("--output", "-o", default=None)
    r.add_argument(
        "--sharded", action="store_true",
        help="render over all local devices (rays striped across the mesh)",
    )
    r.set_defaults(fn=cmd_render)

    m = sub.add_parser("mesh", help="hierarchical refine + marching cubes -> OBJ/VTK")
    _add_scene_arg(m)
    m.add_argument("--refine", type=int, default=3, help="refinement levels")
    m.add_argument("--init-factor", type=int, default=32)
    m.add_argument("--bb-size", type=float, default=5.0)
    m.add_argument("--newton-iters", type=int, default=24)
    m.add_argument("--interpolate-edges", action="store_true")
    m.add_argument(
        "--sharded", action="store_true",
        help="shard-local refine + extraction over all local devices",
    )
    m.add_argument("--checkpoint", default=None, help="save field npz per level")
    m.add_argument("--resume", default=None, help="resume from a field npz; --refine counts further levels")
    m.add_argument("--output", "-o", default=None)
    m.set_defaults(fn=cmd_mesh)

    a = sub.add_parser("animate", help="render a camera orbit or object motion")
    _add_scene_arg(a)
    common_camera(a)
    a.add_argument("--frames", type=int, default=8)
    a.add_argument(
        "--motion", choices=["none", "axis", "spheric"], default="none",
        help="object translation motion (reference example_scene.rs:63-101)",
    )
    a.add_argument(
        "--rotate", action="store_true",
        help="compose a RotateAxisMotion about +Y (example_scene.rs:63-67)",
    )
    a.add_argument("--cycle-duration", type=float, default=5.0)
    a.add_argument("--seconds", type=float, default=5.0, help="animated time span")
    a.add_argument(
        "--enable-movement", action=argparse.BooleanOptionalAction, default=True,
        help="the reference's ExampleSceneSettings.enable_movement gate (M key)",
    )
    a.add_argument("--output", "-o", default=None)
    a.add_argument(
        "--gif", default=None,
        help="also assemble frames into a looping animated GIF at this path "
        "(headless stand-in for the reference's 60 Hz window)",
    )
    a.set_defaults(fn=cmd_animate)

    rm = sub.add_parser("remesh", help="mesh asset -> grid SDF -> adaptive re-extraction")
    rm.add_argument("--input", "-i", required=True, help="source OBJ")
    rm.add_argument("--grid-resolution", type=int, default=128)
    rm.add_argument("--init-factor", type=int, default=32)
    rm.add_argument("--refine", type=int, default=2)
    rm.add_argument("--newton-iters", type=int, default=8)
    rm.add_argument("--output", "-o", default=None)
    rm.set_defaults(fn=cmd_remesh)

    ft = sub.add_parser("fit", help="inverse rendering: recover SDF params from depth or image")
    _add_scene_arg(ft)
    common_camera(ft)
    ft.add_argument("--steps", type=int, default=60)
    ft.add_argument("--lr", type=float, default=0.2)
    ft.add_argument(
        "--image", action="store_true",
        help="fit an L2 image loss (photometric + silhouette) instead of depth",
    )
    ft.add_argument(
        "--perturb", default=None,
        help="key=factor[,key=factor]: which params to perturb and recover "
        "(default for the reference scene: sphere_radius=1.3,smooth_k=0.6)",
    )
    ft.set_defaults(fn=cmd_fit)
    ft.set_defaults(width=64, height=64)

    se = sub.add_parser("session", help="scripted refine/advance stage machine")
    _add_scene_arg(se)
    se.add_argument("--keys", default="vbbbvv", help="key script: b=refine, v=advance")
    se.add_argument("--commands", default=None, help="comma list: refine,advance,...")
    se.add_argument("--init-factor", type=int, default=32)
    se.add_argument("--bb-size", type=float, default=5.0)
    se.add_argument("--output", "-o", default=None)
    se.set_defaults(fn=cmd_session)

    b = sub.add_parser("bench", help="operating-point benchmarks")
    b.add_argument(
        "--which",
        choices=["all", "render", "refine", "mc", "grad", "scaling"],
        default="all",
    )
    b.add_argument("--width", type=int, default=1920)
    b.add_argument("--height", type=int, default=1080)
    b.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a jax.profiler xplane of the benched region into DIR",
    )
    b.add_argument(
        "--roofline", action="store_true",
        help="render/refine: print measured step stats + %% of speed-of-light",
    )
    b.set_defaults(fn=cmd_bench)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
