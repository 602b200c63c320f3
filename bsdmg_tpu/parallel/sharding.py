"""Multi-device sharding: rays and voxel blocks over a `jax.sharding.Mesh`.

The reference is single-GPU with zero inter-device communication
(``CudaDevice::new(0)``, src/cuda/mod.rs:52; PCIe memcpys only). The
scaling story here (SURVEY §2.4, §7):

* **Rays** shard over the image row axis ("dp") and column axis ("sp") of a
  2-D device mesh — the structural analogue of data/sequence parallelism for
  this workload. SDF parameters are a tiny pytree, replicated.
* **Voxel blocks** shard over the batch axis for refinement/extraction.
* **Gradients** of the replicated params are partial sums per shard; XLA
  inserts the all-reduce automatically when we jit with replicated
  out-shardings (overlap with the backward pass is XLA's job — we keep the
  program a single fused jit).
* Multi-host: same code path — ``jax.distributed.initialize()`` plus a global
  mesh (see ``parallel/multihost.py``).

Work imbalance note: sky rays finish in a few steps, silhouette rays run to
the step limit. Sharding contiguous row *blocks* would put whole-object rows
on one chip; :func:`shard_rays` therefore supports interleaved row assignment
(``interleave=True``) which stripes rows round-robin across devices — the
load-balance analogue of the reference's warp swizzle (common.cu:186-215).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.grad import render_image_diff
from bsdmg_tpu.ops.shade import render_image, render_image_c

SceneFn = Callable[[Any, jax.Array], jax.Array]


def make_mesh(
    devices=None, shape: tuple[int, int] | None = None, axis_names=("dp", "sp")
) -> Mesh:
    """Build a 2-D device mesh (rows x cols of the image).

    ``shape=None`` puts all devices on the first ("dp") axis — the right
    default for row-sharded rendering; pass e.g. ``(4, 2)`` for 2-D sharding.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def interleave_rows(h: int, n_shards: int) -> np.ndarray:
    """Permutation striping rows round-robin across shards (load balance)."""
    order = np.argsort(np.arange(h) % n_shards, kind="stable")
    return order


def shard_rays(origins, dirs, cone, mesh: Mesh, *, interleave: bool = True):
    """Place a ``(H, W, ...)`` ray bundle on the mesh: rows over "dp", columns
    over "sp". With ``interleave`` the rows are striped first so each device
    gets a representative slice of the image (cheap sky + expensive object
    rows alike). Returns ``(origins, dirs, cone, unpermute)``; apply
    ``unpermute`` to rendered images to restore scanline order."""
    h = origins.shape[0]
    n_dp = mesh.shape["dp"]
    if interleave and n_dp > 1:
        order = interleave_rows(h, n_dp)
        inverse = np.argsort(order)
        origins = origins[order]
        dirs = dirs[order]
        cone = cone[order]
        unpermute = lambda img: img[inverse]
    else:
        unpermute = lambda img: img

    ray_sharding = NamedSharding(mesh, P("dp", "sp"))
    origins = jax.device_put(origins, ray_sharding)
    dirs = jax.device_put(dirs, ray_sharding)
    cone = jax.device_put(cone, ray_sharding)
    return origins, dirs, cone, unpermute


def render_sharded(
    scene: SceneFn,
    params: Any,
    origins: jax.Array,
    directions: jax.Array,
    cone: jax.Array,
    mesh: Mesh,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
    csdf=None,
):
    """Forward render with rays sharded over the mesh, params replicated.

    ``use_grad_normal`` defaults to ``False`` — the reference's fd4 stencil,
    matching the single-device ``render_image`` default, so sharded and
    direct renders of the same scene are identical by default.

    SDF evaluation is embarrassingly parallel over rays, so the only
    communication is the initial params broadcast; each device traces its
    image shard independently (no resharding until the host gathers pixels).
    """
    replicated = NamedSharding(mesh, P())
    out_sharding = NamedSharding(mesh, P("dp", "sp"))
    params = jax.device_put(params, replicated)

    if csdf is not None:
        # SoA fast path: coordinate planes, full lane occupancy (~20x)
        return _render_sharded_c_jit(
            csdf, config, use_grad_normal, out_sharding, params, origins,
            directions, cone,
        )
    return _render_sharded_points_jit(
        scene, config, use_grad_normal, out_sharding, params, origins,
        directions, cone,
    )


# module-level jitted bodies: cached per (scene/csdf, config, normals,
# sharding) across calls — a jit defined inside render_sharded would make
# every frame a fresh wrapper that recompiles the sharded render
# (tests/test_parallel.py::test_scaling_overhead_proxy counts compilations)
@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _render_sharded_points_jit(
    scene_fn, config, use_grad_normal, out_sharding, p, o, d, c
):
    img = render_image(
        lambda q: scene_fn(p, q), o, d, c, config,
        use_grad_normal=use_grad_normal,
    )
    return jax.lax.with_sharding_constraint(img, out_sharding)


@partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _render_sharded_c_jit(
    component_fn, config, use_grad_normal, out_sharding, p, o, d, c
):
    img = render_image_c(
        component_fn, p, o, d, c, config, use_grad_normal=use_grad_normal
    )
    return jax.lax.with_sharding_constraint(img, out_sharding)


@partial(
    jax.jit,
    static_argnums=(0, 1, 8, 9, 10),
    donate_argnums=(2, 3),
)
def _train_step_jit(
    scene_fn, opt, p, opt_st, tgt, o, d, c, component_fn, mesh, config
):
    """Module-level jitted train step: cached per (scene, optimizer, csdf,
    mesh, config) across every optimizer iteration — a jit defined inside
    ``train_step`` would retrace the whole sharded graph on every call."""
    replicated = NamedSharding(mesh, P())

    def loss_fn(pp):
        img = render_image_diff(scene_fn, pp, o, d, c, config, csdf=component_fn)
        return jnp.mean((img - tgt) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(p)
    # params are replicated; grads reduce over the mesh automatically.
    updates, opt_st = opt.update(grads, opt_st, p)
    import optax

    p = optax.apply_updates(p, updates)
    p = jax.lax.with_sharding_constraint(p, replicated)
    return p, opt_st, loss


def train_step(
    scene: SceneFn,
    params: Any,
    opt_state: Any,
    optimizer,
    target: jax.Array,
    origins: jax.Array,
    directions: jax.Array,
    cone: jax.Array,
    mesh: Mesh,
    config: MarchConfig = MarchConfig(),
    csdf=None,
):
    """One inverse-rendering step: sharded differentiable render, L2 loss,
    gradient all-reduce (XLA-inserted), replicated optimizer update.

    Returns ``(params, opt_state, loss)``. Jit-cached per
    (scene, optimizer, csdf, mesh, config).
    """
    return _train_step_jit(
        scene, optimizer, params, opt_state, target, origins, directions,
        cone, csdf, mesh, config,
    )


@partial(
    jax.jit,
    static_argnames=("csdf", "mesh", "config", "bb", "split", "interpret"),
)
def _render_sharded_kernel_jit(csdf, origins, directions, cone, mesh, config,
                               bb, split, interpret=False):
    from bsdmg_tpu.ops.pallas.render_triton import TILE_H, render_image_triton

    h, w = origins.shape[:2]
    n = mesh.devices.size
    band = n * TILE_H
    hp = -(-h // band) * band
    cone = jnp.broadcast_to(jnp.asarray(cone, jnp.float32), (h, w))
    # pad rows with rays that start far outside the scene (instant sky)
    fill = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), (hp - h, w, 3))
    origins = jnp.concatenate([origins, fill((1e5, 1e5, 1e5))])
    directions = jnp.concatenate([directions, fill((1.0, 0.0, 0.0))])
    cone = jnp.concatenate([cone, jnp.zeros((hp - h, w), jnp.float32)])

    def stripe(x):
        # deal TILE_H-row bands round-robin: shard i gets bands i, i+n, ...
        # (a representative mix of sky and object rows on every card)
        t = x.reshape(hp // band, n, TILE_H, *x.shape[1:])
        return t.swapaxes(0, 1).reshape(x.shape)

    def unstripe(x):
        t = x.reshape(n, hp // band, TILE_H, *x.shape[1:])
        return t.swapaxes(0, 1).reshape(x.shape)

    axes = tuple(mesh.axis_names)  # flatten every mesh axis onto the rows
    rows3, rows2 = P(axes, None, None), P(axes, None)
    local = jax.shard_map(
        lambda o, d, c: render_image_triton(csdf, o, d, c, config, bb=bb,
                                            split=split, interpret=interpret),
        mesh=mesh, in_specs=(rows3, rows3, rows2), out_specs=rows3,
        check_vma=False,
    )
    img = local(stripe(origins), stripe(directions), stripe(cone))
    return unstripe(img)[:h]


def render_sharded_kernel(
    csdf,
    origins: jax.Array,
    directions: jax.Array,
    cone: jax.Array,
    mesh: Mesh,
    config: MarchConfig = MarchConfig(),
    *,
    bb: tuple | None = None,
    split=None,
    interpret: bool = False,
):
    """Multi-device render with the GPU tile kernel on every device, under
    ``shard_map``: rows of 8 pixels are dealt round-robin across all devices
    (both mesh axes flattened), each device renders its rows, and the image
    is gathered back. The scene is a param-baked component SDF
    (``compile_scene_csdf``); SDF evaluation is embarrassingly parallel, so
    the only traffic is the initial deal and the final gather.

    Takes the full unsharded ray image (scanline order) and returns the full
    image; do not pre-permute with ``shard_rays``. ``interpret`` runs the
    kernel in the Pallas interpreter (tests on a machine without a GPU)."""
    return _render_sharded_kernel_jit(
        csdf, origins, directions, cone, mesh, config, bb, split, interpret
    )
