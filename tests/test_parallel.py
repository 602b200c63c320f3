"""Sharding tests on the 8-device virtual CPU mesh.

Asserts sharded == single-device results and exercises the full multi-chip
training step (render -> loss -> grad all-reduce -> optimizer update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.grad import render_image_diff
from bsdmg_tpu.models import reference_render_scene, sphere_scene
from bsdmg_tpu.ops.shade import render_image
from bsdmg_tpu.parallel import make_mesh, render_sharded, shard_rays, train_step
from bsdmg_tpu.parallel.multihost import shard_voxels


def _rays(w=32, h=16):
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    return generate_rays(cam, (w, h), (float(w), float(h)))


class TestMesh:
    def test_default_mesh_uses_all_devices(self):
        mesh = make_mesh()
        assert mesh.shape["dp"] == 8
        assert mesh.shape["sp"] == 1

    def test_2d_mesh(self):
        mesh = make_mesh(shape=(4, 2))
        assert mesh.shape == {"dp": 4, "sp": 2}

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError):
            make_mesh(shape=(3, 2))


class TestShardedRender:
    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
    def test_matches_single_device(self, shape):
        scene = reference_render_scene()
        origins, dirs, cone = _rays(32, 16)
        single = render_image(scene.bind(), origins, dirs, cone)

        mesh = make_mesh(shape=shape)
        o, d, c, unpermute = shard_rays(origins, dirs, cone, mesh)
        img = render_sharded(scene.sdf, scene.params, o, d, c, mesh)
        img = unpermute(np.asarray(img))
        # atol 1e-4: the fd4 normal stencil amplifies ulp-level hit-depth
        # differences between the sharded and direct fusion layouts
        np.testing.assert_allclose(img, np.asarray(single), atol=1e-4)

    def test_interleaved_rows_restore_order(self):
        scene = sphere_scene(1.0)
        origins, dirs, cone = _rays(16, 16)
        single = render_image(scene.bind(), origins, dirs, cone)

        mesh = make_mesh(shape=(8, 1))
        o, d, c, unpermute = shard_rays(origins, dirs, cone, mesh, interleave=True)
        img = unpermute(np.asarray(render_sharded(scene.sdf, scene.params, o, d, c, mesh)))
        np.testing.assert_allclose(img, np.asarray(single), atol=1e-4)


class TestShardedGradients:
    def test_grads_match_single_device(self):
        scene = reference_render_scene()
        origins, dirs, cone = _rays(32, 16)
        target = jnp.zeros(origins.shape[:-1] + (3,), jnp.float32)

        def loss_fn(p, o, d, c):
            img = render_image_diff(scene.sdf, p, o, d, c)
            return jnp.mean((img - target) ** 2)

        g_single = jax.grad(loss_fn)(scene.params, origins, dirs, cone)

        mesh = make_mesh(shape=(4, 2))
        o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
        target_sharded = jax.device_put(target, NamedSharding(mesh, P("dp", "sp")))

        def loss_sharded(p, oo, dd, cc):
            img = render_image_diff(scene.sdf, p, oo, dd, cc)
            return jnp.mean((img - target_sharded) ** 2)

        g_sharded = jax.jit(jax.grad(loss_sharded))(scene.params, o, d, c)
        for k in g_single:
            np.testing.assert_allclose(
                np.asarray(g_single[k]), np.asarray(g_sharded[k]), atol=1e-5
            ), k


class TestTrainStep:
    def test_full_training_step(self):
        scene = sphere_scene(1.0)
        origins, dirs, cone = _rays(16, 16)
        target = render_image_diff(
            scene.sdf, {"radius": jnp.float32(1.0)}, origins, dirs, cone
        )

        mesh = make_mesh()
        o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
        target = jax.device_put(target, NamedSharding(mesh, P("dp", "sp")))

        params = {"radius": jnp.float32(1.1)}
        optimizer = optax.adam(1e-2)
        opt_state = optimizer.init(params)

        losses = []
        for _ in range(5):
            params, opt_state, loss = train_step(
                scene.sdf, params, opt_state, optimizer, target, o, d, c, mesh
            )
            losses.append(float(loss))
        assert losses[-1] < losses[0]
        assert np.isfinite(losses).all()


class TestVoxelSharding:
    def test_refine_sharded_matches(self):
        from bsdmg_tpu.ops.refine import refine_step

        scene = sphere_scene(1.0).bind()
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field

        cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
        field = create_voxel_field(cfg)

        out_s, count_s, size_s = jax.jit(
            lambda l, c, v: refine_step(scene, l, c, v), static_argnums=()
        )(field.lowers, jnp.int32(field.count), jnp.float32(field.voxel_size))

        mesh = make_mesh()
        lowers = shard_voxels(field.lowers, mesh)
        out_m, count_m, size_m = jax.jit(
            lambda l, c, v: refine_step(scene, l, c, v)
        )(lowers, jnp.int32(field.count), jnp.float32(field.voxel_size))

        assert int(count_s) == int(count_m)
        n = int(count_s)
        np.testing.assert_allclose(
            np.asarray(out_s)[:n], np.asarray(out_m)[:n], atol=1e-6
        )


def test_benchmark_scaling_mechanism():
    """The scaling benchmark runs on the virtual CPU mesh and reports a
    finite efficiency (wall-clock on emulated devices is not meaningful;
    this pins the mechanism the real-hardware run uses)."""
    from bsdmg_tpu.bench import benchmark_scaling

    r = benchmark_scaling(width=128, height=64, iters=1)
    assert r["devices"] == 8
    assert np.isfinite(r["rays_per_s"]) and r["rays_per_s"] > 0
    assert np.isfinite(r["efficiency"])


def test_scaling_overhead_proxy():
    """Sharding adds no work, counted rather than timed: repeated sharded
    renders and train steps compile once, every device holds 1/N of the
    rays and of the image, and the compiled per-device program does 1/N of
    the unsharded program's FLOPs (XLA's cost analysis)."""
    from bsdmg_tpu.config import MarchConfig
    from bsdmg_tpu.ops.shade import render_image_c
    from bsdmg_tpu.parallel.sharding import _render_sharded_c_jit, _train_step_jit

    scene = reference_render_scene()
    h, w = 32, 64
    origins, dirs, cone = _rays(w, h)
    mesh = make_mesh()
    n = mesh.devices.size
    o, d, c, _ = shard_rays(origins, dirs, cone, mesh)
    assert {s.data.shape for s in o.addressable_shards} == {(h // n, w, 3)}

    before = _render_sharded_c_jit._cache_size()
    for _ in range(3):
        img = render_sharded(scene.sdf, scene.params, o, d, c, mesh, csdf=scene.csdf)
    assert _render_sharded_c_jit._cache_size() == before + 1
    assert {s.data.shape for s in img.addressable_shards} == {(h // n, w, 3)}

    def flops(lowered):
        ca = lowered.compile().cost_analysis()
        return float((ca[0] if isinstance(ca, list) else ca)["flops"])

    out = NamedSharding(mesh, P("dp", "sp"))
    per_device = flops(_render_sharded_c_jit.lower(
        scene.csdf, MarchConfig(), False, out, scene.params, o, d, c
    ))
    whole = flops(jax.jit(
        lambda o_, d_, c_: render_image_c(scene.csdf, scene.params, o_, d_, c_)
    ).lower(origins, dirs, cone))
    assert per_device * n == pytest.approx(whole, rel=0.1)

    params = {k: v for k, v in scene.params.items()
              if k not in ("object_center", "object_rotation")}
    target = jax.device_put(jnp.zeros((h, w, 3), jnp.float32), out)
    opt = optax.sgd(1e-3)
    before = _train_step_jit._cache_size()
    for _ in range(3):
        p = jax.tree.map(lambda v: jnp.array(v, jnp.float32), params)
        train_step(scene.sdf, p, opt.init(p), opt, target, o, d, c, mesh,
                   csdf=scene.csdf)
    assert _train_step_jit._cache_size() == before + 1


def test_render_sharded_csdf_matches_points_path():
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.parallel import make_mesh, render_sharded, shard_rays

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (128, 64), (1920.0, 1080.0))
    mesh = make_mesh()
    o, d, c, unpermute = shard_rays(origins, dirs, cone, mesh)
    a = np.asarray(render_sharded(scene.sdf, scene.params, o, d, c, mesh,
                                  use_grad_normal=False))
    b = np.asarray(render_sharded(scene.sdf, scene.params, o, d, c, mesh,
                                  csdf=scene.csdf))
    diff = np.abs(a - b)
    assert (diff.max(-1) > 1e-3).mean() < 0.005


def test_render_sharded_pallas_matches_single_device():
    """shard_map + the tile kernel (interpret mode) over the 8-device mesh ==
    the single-device XLA render, for ragged heights too (row bands are
    padded to a whole number per device)."""
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.pallas.csdf import compile_scene_split, scene_bounds
    from bsdmg_tpu.ops.shade import render_image_c
    from bsdmg_tpu.parallel import render_sharded_kernel

    scene = reference_render_scene()
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    origins, dirs, cone = generate_rays(cam, (96, 70), (1920.0, 1080.0))
    mesh = make_mesh()
    img = np.asarray(render_sharded_kernel(
        compile_scene_csdf(scene), origins, dirs, cone, mesh,
        bb=scene_bounds(scene), split=compile_scene_split(scene),
        interpret=True,
    ))
    ref = np.asarray(jax.jit(
        lambda o, d, c: render_image_c(scene.csdf, scene.params, o, d, c)
    )(origins, dirs, cone))
    assert img.shape == ref.shape == (70, 96, 3)
    diff = np.abs(img - ref)
    assert (diff.max(-1) > 2e-2).mean() == 0.0
    assert diff.mean() < 1e-4


class TestShardedMeshGeneration:
    def test_sharded_mesh_equals_single_device(self):
        """Full sharded pipeline (distribute -> shard-local refine ->
        shard-local extract -> weld) produces the same welded vertex set as
        the single-device pipeline on the 8-device mesh."""
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import generate_mesh
        from bsdmg_tpu.models import reference_object
        from bsdmg_tpu.ops.pallas import compile_scene_csdf
        from bsdmg_tpu.parallel import generate_mesh_sharded, make_mesh

        scene = reference_object()
        csdf = compile_scene_csdf(scene)
        cfg = MeshGenConfig(init_factor=8)
        single = generate_mesh(scene.bind(), refine_steps=1, config=cfg, csdf=csdf)
        mesh = make_mesh()
        sharded = generate_mesh_sharded(
            scene.bind(), mesh, refine_steps=1, config=cfg, csdf=csdf
        )

        assert sharded.triangle_count == single.triangle_count
        assert sharded.vertex_count == single.vertex_count
        a = np.asarray(single.vertices)
        b = np.asarray(sharded.vertices)
        np.testing.assert_allclose(
            a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-6
        )

    def test_sharded_refine_counts(self):
        """Shard-local refinement finds exactly the single-device survivor
        set, distributed across shards."""
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import create_voxel_field, refine_field
        from bsdmg_tpu.models import sphere_scene
        from bsdmg_tpu.parallel import distribute_field, make_mesh, refine_field_sharded
        from bsdmg_tpu.parallel.mesh import ShardedField

        scene = sphere_scene(1.0)
        cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
        field = create_voxel_field(cfg)
        single = refine_field(scene.bind(), field, cfg)

        mesh = make_mesh()
        sfield = distribute_field(field, mesh)
        refined = refine_field_sharded(scene.bind(), sfield, cfg, mesh)
        assert refined.count == single.count

        # capacity hygiene (CLAUDE.md rule): the inflated refine output must
        # shrink back to the worst shard's rounded live count, or dead
        # padding compounds ~2x per level through every later sort/march
        from bsdmg_tpu.mesh.field import _round_capacity

        assert refined.local_capacity == _round_capacity(
            int(max(refined.counts))
        )

        # the union of shard-local live rows equals the single-device set
        n = len(refined.counts)
        buf = np.asarray(refined.lowers).reshape(n, -1, 3)
        rows = np.concatenate(
            [buf[d, : refined.counts[d]] for d in range(n)]
        )
        a = np.asarray(single.live_lowers())
        np.testing.assert_allclose(
            a[np.lexsort(a.T)], rows[np.lexsort(rows.T)], atol=1e-6
        )


class TestTrainStepMeshes:
    @pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
    def test_step_matches_single_device(self, shape):
        """The sharded training step (GSPMD value_and_grad, all-reduced
        gradients, replicated update) gives the single-device step's loss
        and updated params; only the reduction order differs."""
        scene = reference_render_scene()
        params = {
            k: v
            for k, v in scene.params.items()
            if k not in ("object_center", "object_rotation")
        }
        origins, dirs, cone = _rays(64, 32)
        rng = np.random.default_rng(0)
        target = jnp.asarray(rng.uniform(0, 1, (32, 64, 3)), jnp.float32)
        opt = optax.sgd(1e-2)

        def run(mesh):
            o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
            tgt = jax.device_put(target, NamedSharding(mesh, P("dp", "sp")))
            p = jax.tree.map(lambda v: jnp.array(v, jnp.float32), params)
            new_p, _, loss = train_step(
                scene.sdf, p, opt.init(p), opt, tgt, o, d, c, mesh,
                csdf=scene.csdf,
            )
            return float(loss), {k: np.asarray(v) for k, v in new_p.items()}

        loss1, p1 = run(make_mesh(jax.devices()[:1], shape=(1, 1)))
        lossn, pn = run(make_mesh(shape=shape))
        assert lossn == pytest.approx(loss1, rel=1e-4)
        for k in p1:
            np.testing.assert_allclose(pn[k], p1[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sharded_field_gather_roundtrip():
    """ShardedField.gather() recovers the exact live voxel set for
    single-device consumers (checkpointing, welding)."""
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import create_voxel_field, refine_field
    from bsdmg_tpu.models import sphere_scene
    from bsdmg_tpu.parallel import distribute_field, make_mesh, refine_field_sharded

    scene = sphere_scene(1.0)
    cfg = MeshGenConfig(init_factor=8, bb_size=4.0)
    field = create_voxel_field(cfg)
    single = refine_field(scene.bind(), field, cfg)

    mesh = make_mesh()
    refined = refine_field_sharded(
        scene.bind(), distribute_field(field, mesh), cfg, mesh
    )
    gathered = refined.gather()
    assert gathered.count == single.count
    a = np.asarray(single.live_lowers())
    b = np.asarray(gathered.live_lowers())
    np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-6)


def test_render_grid_sharded_matches_single():
    """Mesh-asset serving over the 8-device mesh: the sharded XLA march over
    the baked grid reproduces the single-device image."""
    from bsdmg_tpu.models.mesh_sdf import SdfGrid, grid_scene
    from bsdmg_tpu.ops.shade import render_image_c

    r, lo, hi = 48, -1.5, 1.5
    ax = np.linspace(lo, hi, r, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.sqrt(X * X + Y * Y + Z * Z) - 1.0
    scene = grid_scene(SdfGrid(values=vals, lo=(lo,) * 3, hi=(hi,) * 3))

    cam = look_at((2.5, 1.0, -2.5), (0.0, 0.0, 0.0), fov=np.pi / 4)
    h, w = 64, 128
    origins, dirs, cone = generate_rays(cam, (w, h), (float(w), float(h)))
    single = np.asarray(jax.jit(
        lambda o, d, c: render_image_c(scene.csdf, scene.params, o, d, c)
    )(origins, dirs, cone))
    mesh = make_mesh()
    o, d, c, unpermute = shard_rays(origins, dirs, cone, mesh)
    sharded = unpermute(np.asarray(render_sharded(
        scene.sdf, scene.params, o, d, c, mesh, csdf=scene.csdf,
    )))
    assert np.isfinite(sharded).all()
    match = np.all(np.abs(single - sharded) < 1e-4, axis=-1).mean()
    assert match > 0.999, float(match)
