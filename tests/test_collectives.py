"""HLO collective-op audit of the production sharded paths.

The scaling-efficiency story (PARITY.md: near-perfect weak scaling — the
reference is single-GPU with zero inter-device traffic, src/cuda/mod.rs:52)
is made auditable without multi-chip hardware by compiling the SPMD
programs on the 8-device virtual CPU mesh and counting collective ops in
the partitioned HLO:

* ``render_sharded_kernel`` (the tile kernel under ``shard_map``, interpret
  mode here) and ``render_sharded`` (the XLA march under GSPMD) — ZERO
  reductions in the march: ray tracing is embarrassingly parallel. The
  kernel path's only collectives assemble the returned frame.
* ``train_step`` (XLA autodiff path) — only all-reduces (the XLA-inserted
  gradient/loss reductions; the exact count is a partitioner choice that
  has been observed at 2-4), never a gather/scatter/permute collective, on
  every mesh shape.

If someone adds a hot-path collective (a resharding ``with_sharding_
constraint``, an accidental global reduction inside the march), these
counts change and this test fails.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.models import reference_render_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import scene_bounds
from bsdmg_tpu.parallel import make_mesh, shard_rays
from bsdmg_tpu.parallel.sharding import (
    _render_sharded_c_jit,
    _render_sharded_kernel_jit,
    _train_step_jit,
)

# matches "  %name = <type> all-reduce(..." including tuple-typed ops
# (spaces inside the type) and async -start variants
_COLLECTIVE = re.compile(
    r" (all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter)"
    r"(?:-start)?\("
)


def _collective_counts(compiled_text: str) -> dict:
    counts: dict = {}
    for m in _COLLECTIVE.finditer(compiled_text):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


@pytest.fixture(scope="module")
def setup():
    mesh = make_mesh(shape=(4, 2))
    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    h, w = 32, 64
    origins, dirs, cone = generate_rays(cam, (w, h), (1920.0, 1080.0))
    return mesh, scene, origins, dirs, cone, h, w


class TestRenderHotPathHasNoCollectives:
    def test_sharded_pallas_render(self, setup):
        mesh, scene, origins, dirs, cone, h, w = setup
        cone_full = jnp.broadcast_to(jnp.asarray(cone, jnp.float32), (h, w))
        rep = NamedSharding(mesh, P())
        o, d, c = (jax.device_put(x, rep) for x in (origins, dirs, cone_full))
        txt = (
            _render_sharded_kernel_jit.lower(
                compile_scene_csdf(scene), o, d, c, mesh, MarchConfig(),
                scene_bounds(scene), None, True,
            )
            .compile()
            .as_text()
        )
        counts = _collective_counts(txt)
        # the march itself communicates nothing (no reduction of any kind);
        # the gather and permutes assemble the dealt row bands into the
        # returned frame
        assert counts == {"all-gather": 1, "collective-permute": 2}, counts

    def test_sharded_xla_render(self, setup):
        mesh, scene, origins, dirs, cone, h, w = setup
        o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
        out = NamedSharding(mesh, P("dp", "sp"))
        txt = (
            _render_sharded_c_jit.lower(
                scene.csdf, MarchConfig(), False, out, scene.params, o, d, c,
            )
            .compile()
            .as_text()
        )
        # the image stays sharded where it was rendered: nothing to gather,
        # and the while loop's any-active test reduces across devices
        counts = _collective_counts(txt)
        assert set(counts) <= {"all-reduce"}, counts


class TestTrainStepCollectiveBudget:
    @pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
    def test_train_step_collectives_per_mesh(self, setup, shape):
        _, scene, origins, dirs, cone, h, w = setup
        mesh = make_mesh(shape=shape)
        params = {k: jnp.array(v) for k, v in scene.params.items()}
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
        target = jax.device_put(
            jnp.zeros((h, w, 3), jnp.float32), NamedSharding(mesh, P("dp", "sp"))
        )
        txt = (
            _train_step_jit.lower(
                scene.sdf, opt, params, opt_state, target, o, d, c,
                scene.csdf, mesh, MarchConfig(),
            )
            .compile()
            .as_text()
        )
        counts = _collective_counts(txt)
        assert set(counts) == {"all-reduce"}, counts
        assert counts["all-reduce"] <= 4, counts

    def test_xla_step_all_reduces_only(self, setup):
        mesh, scene, origins, dirs, cone, h, w = setup
        params = {k: jnp.array(v) for k, v in scene.params.items()}
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)
        o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
        target = jax.device_put(
            jnp.zeros((h, w, 3), jnp.float32), NamedSharding(mesh, P("dp", "sp"))
        )
        txt = (
            _train_step_jit.lower(
                scene.sdf, opt, params, opt_state, target, o, d, c,
                scene.csdf, mesh, MarchConfig(),
            )
            .compile()
            .as_text()
        )
        counts = _collective_counts(txt)
        # reduction count is a partitioner choice (observed 2-4); the
        # contract is: reductions only, and few — no gather/permute/scatter
        # collectives, no unbounded growth
        assert set(counts) == {"all-reduce"}, counts
        assert counts["all-reduce"] <= 4, counts
