"""Mesh-asset SDF tests: exact signed distance, grid bake, round-trip pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from bsdmg_tpu.config import MeshGenConfig
from bsdmg_tpu.mesh import generate_mesh
from bsdmg_tpu.models import sphere_scene
from bsdmg_tpu.models.mesh_sdf import (
    bake_mesh_grid,
    grid_sdf,
    mesh_signed_distance,
)


def _icosphere_mesh():
    """Unit-sphere mesh generated by our own pipeline (no external assets)."""
    cfg = MeshGenConfig(init_factor=16, bb_size=4.0)
    return generate_mesh(sphere_scene(1.0).bind(), refine_steps=1, config=cfg)


class TestExactDistance:
    def test_single_triangle_regions(self):
        v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        f = np.asarray([[0, 1, 2]], np.int32)
        pts = np.asarray(
            [
                [0.25, 0.25, 1.0],  # above interior -> 1.0
                [-1.0, 0.0, 0.0],  # beyond vertex A -> 1.0
                [0.5, -2.0, 0.0],  # below edge AB -> 2.0
                [1.0, 1.0, 0.0],  # beyond edge BC -> sqrt(2)/2
            ],
            np.float32,
        )
        d = np.abs(np.asarray(mesh_signed_distance(pts, v, f)))
        np.testing.assert_allclose(d, [1.0, 1.0, 2.0, np.sqrt(2) / 2], atol=1e-5)

    def test_sphere_mesh_distance_and_sign(self):
        mesh = _icosphere_mesh()
        rng = np.random.RandomState(0)
        pts = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
        d = np.asarray(mesh_signed_distance(pts, mesh.vertices, mesh.faces))
        analytic = np.linalg.norm(pts, axis=1) - 1.0
        # mesh is a faceted sphere: distances within a voxel-ish tolerance
        keep = np.abs(analytic) > 0.05  # away from the faceting ambiguity
        np.testing.assert_allclose(d[keep], analytic[keep], atol=0.03)
        assert np.all(np.sign(d[keep]) == np.sign(analytic[keep]))


class TestGrid:
    def test_bake_and_interpolate(self):
        mesh = _icosphere_mesh()
        grid = bake_mesh_grid(mesh.vertices, mesh.faces, resolution=48)
        sdf = grid_sdf(grid)
        rng = np.random.RandomState(1)
        pts = rng.uniform(-1.1, 1.1, (128, 3)).astype(np.float32)
        got = np.asarray(sdf(jnp.asarray(pts)))
        analytic = np.linalg.norm(pts, axis=1) - 1.0
        np.testing.assert_allclose(got, analytic, atol=0.08)

    def test_outside_grid_fallback_positive(self):
        mesh = _icosphere_mesh()
        grid = bake_mesh_grid(mesh.vertices, mesh.faces, resolution=32)
        sdf = grid_sdf(grid)
        far = jnp.asarray([[10.0, 0.0, 0.0], [0.0, -8.0, 3.0]])
        d = np.asarray(sdf(far))
        assert (d > 5.0).all()

    def test_outside_fallback_never_overshoots(self):
        """Sphere-trace soundness outside the grid box: the returned value
        must LOWER-bound the true surface distance for every exterior point
        (the pre-round-3 ``interior + dist_to_box`` was an UPPER bound —
        triangle-inequality slack near box corners overshot thin features;
        for a centered sphere it violates whenever the approach is
        diagonal: |b| + |p-b| >= |p|)."""
        mesh = _icosphere_mesh()
        grid = bake_mesh_grid(mesh.vertices, mesh.faces, resolution=32)
        sdf = grid_sdf(grid)
        rng = np.random.RandomState(3)
        # points outside the grid box (|coord| > grid hi ~ 1.1) from all
        # octants, including deep diagonals where the old bound was worst
        pts = rng.uniform(1.3, 6.0, (256, 3)).astype(np.float32)
        pts *= rng.choice([-1.0, 1.0], size=pts.shape).astype(np.float32)
        got = np.asarray(sdf(jnp.asarray(pts)))
        true = np.linalg.norm(pts, axis=1) - 1.0
        # 0.09: grid quantization of the icosphere (same budget as
        # test_bake_and_interpolate), NOT geometric overshoot slack
        assert (got <= true + 0.09).all()
        # and it stays a useful positive step, not a degenerate zero
        assert (got > 0.2).all()

    def test_gradient_exists(self):
        import jax

        mesh = _icosphere_mesh()
        grid = bake_mesh_grid(mesh.vertices, mesh.faces, resolution=32)
        sdf = grid_sdf(grid)
        g = jax.grad(lambda p: sdf(p[None])[0])(jnp.asarray([0.7, 0.3, 0.2]))
        n = np.asarray(g) / np.linalg.norm(g)
        radial = np.asarray([0.7, 0.3, 0.2]) / np.linalg.norm([0.7, 0.3, 0.2])
        assert np.dot(n, radial) > 0.95


class TestMeshScenePipeline:
    def test_remesh_round_trip(self):
        """mesh -> grid SDF -> hierarchical extraction -> mesh again."""
        src = _icosphere_mesh()
        grid = bake_mesh_grid(src.vertices, src.faces, resolution=48)
        sdf = grid_sdf(grid)
        cfg = MeshGenConfig(init_factor=16, bb_size=2.6, newton_iters=8)
        out = generate_mesh(sdf, refine_steps=1, config=cfg)
        assert out.triangle_count > 100
        r = np.linalg.norm(out.vertices, axis=1)
        np.testing.assert_allclose(r, 1.0, atol=0.05)


class TestMeshSceneRender:
    """Mesh assets as first-class render targets (the reference loads OBJ
    assets via bevy_obj but never renders them, src/main.rs:65)."""

    def _scene_path(self, tmp_path):
        from bsdmg_tpu.mesh.export import save_obj

        path = str(tmp_path / "ico.obj")
        save_obj(_icosphere_mesh(), path)
        return path

    def test_get_scene_mesh_scheme(self, tmp_path):
        from bsdmg_tpu.cli import _get_scene

        scene = _get_scene(f"mesh:{self._scene_path(tmp_path)}:24")
        assert scene.csdf is not None
        d0 = float(scene.bind()(jnp.zeros((1, 3)))[0])
        assert d0 < -0.5  # inside the unit sphere

    def test_soa_renderer_matches_oracle(self, tmp_path):
        """_make_renderer must pick the SoA component path for grid-SDF
        scenes and match the AoS oracle pixel-for-pixel."""
        import jax

        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.cli import _get_scene, _make_renderer
        from bsdmg_tpu.ops.pallas import compile_scene_csdf
        from bsdmg_tpu.ops.shade import render_image

        scene = _get_scene(f"mesh:{self._scene_path(tmp_path)}:24")
        assert compile_scene_csdf(scene) is None  # a grid has no baked form
        cam = look_at((3.0, 1.0, -3.0), (0.0, 0.0, 0.0))
        origins, dirs, cone = generate_rays(cam, (64, 48), (64.0, 48.0))
        got = np.asarray(_make_renderer(scene)(origins, dirs, cone))
        want = np.asarray(
            jax.jit(lambda o, d, c: render_image(scene.bind(), o, d, c))(
                origins, dirs, cone
            )
        )
        # grid_csdf and grid_sdf build different expression trees for the
        # same trilinear interpolation; ~1e-5 SDF drift through ~100 march
        # steps stays bounded in the shaded [0,1] range
        np.testing.assert_allclose(got, want, atol=1e-3)
        # the sphere must actually be visible (collision pixels shaded)
        assert got.std() > 0.01

    def test_cli_render_mesh_scene(self, tmp_path):
        from bsdmg_tpu.cli import main

        out = str(tmp_path / "ico.png")
        rc = main([
            "render", "--scene", f"mesh:{self._scene_path(tmp_path)}:24",
            "--width", "64", "--height", "48",
            "--camera", "3", "1", "-3", "-o", out,
        ])
        assert rc == 0
        import os

        assert os.path.getsize(out) > 200

    def test_cli_render_mesh_scene_sharded(self, tmp_path):
        """--sharded routes mesh-asset scenes through the sharded XLA march
        on the virtual device mesh and writes a sane PNG."""
        from bsdmg_tpu.cli import main

        out = str(tmp_path / "ico_sharded.png")
        rc = main([
            "render", "--scene", f"mesh:{self._scene_path(tmp_path)}:24",
            "--width", "128", "--height", "64", "--sharded",
            "--camera", "3", "1", "-3", "-o", out,
        ])
        assert rc == 0
        import os

        assert os.path.getsize(out) > 200


def test_grid_csdf_matches_grid_sdf():
    """Component form of the grid interpolation must match the points API
    inside, outside and across the boundary."""
    import jax.numpy as jnp

    from bsdmg_tpu.models.mesh_sdf import bake_mesh_grid, grid_csdf, grid_sdf

    m = _icosphere_mesh()
    grid = bake_mesh_grid(m.vertices, m.faces, resolution=24)
    f = grid_sdf(grid)
    fc = grid_csdf(grid)
    rng = np.random.default_rng(7)
    p = rng.uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)
    a = np.asarray(f(jnp.asarray(p)))
    b = np.asarray(fc(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(p[:, 2])))
    np.testing.assert_allclose(a, b, atol=1e-6)


def _sphere_grid(r, lo=-1.5, hi=1.5):
    from bsdmg_tpu.models.mesh_sdf import SdfGrid

    ax = np.linspace(lo, hi, r, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.sqrt(X * X + Y * Y + Z * Z) - 1.0
    return SdfGrid(values=vals, lo=(lo,) * 3, hi=(hi,) * 3)


@pytest.mark.parametrize(
    "res,camera",
    [
        (32, (2.5, 1.0, -2.5)),
        (48, (2.5, 1.0, -2.5)),
        (64, (2.5, 1.0, -2.5)),
        (48, (0.0, 0.5, -3.5)),
        (48, (-2.0, 2.0, 2.0)),
        (64, (3.0, -1.0, 0.5)),
    ],
)
def test_grid_render_matches_analytic(res, camera):
    """The mesh-asset renderer (XLA component-form march over the baked
    grid's trilinear csdf) images a baked unit sphere like the analytic
    sphere scene, away from silhouettes."""
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.models import sphere_scene
    from bsdmg_tpu.models.mesh_sdf import grid_scene
    from bsdmg_tpu.ops.shade import render_image_c

    grid_sc = grid_scene(_sphere_grid(res))
    ana = sphere_scene(1.0)
    cam = look_at(camera, (0.0, 0.0, 0.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (48, 32), (48.0, 32.0))
    a = np.asarray(render_image_c(grid_sc.csdf, grid_sc.params, o, d, c))
    b = np.asarray(render_image_c(ana.csdf, ana.params, o, d, c))
    assert (b.max(-1) > 0).mean() > 0.1  # the sphere is in view
    match = np.all(np.abs(a - b) < 2e-2, axis=-1).mean()
    assert match > 0.97, float(match)


def test_bake_reference_grid_samples_scene():
    """bake_reference_grid holds the reference object's SDF at the lattice
    nodes (the on-device bake the mesh-asset benchmark renders)."""
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.models.mesh_sdf import bake_reference_grid

    grid = bake_reference_grid(24)
    assert grid.values.shape == (24, 24, 24)
    ax = np.linspace(-2.6, 2.6, 24, dtype=np.float32)
    idx = [(0, 0, 0), (12, 11, 12), (23, 5, 17), (7, 19, 2)]
    pts = np.asarray([[ax[i], ax[j], ax[k]] for i, j, k in idx], np.float32)
    want = np.asarray(reference_object().bind()(jnp.asarray(pts)))
    got = np.asarray(grid.values)[tuple(np.asarray(idx).T)]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_grid_render_matches_analytic():
    """The baked reference object renders like the analytic one at a grid
    fine enough for its 0.1-wide skeleton bars (same check the GPU smoke
    run makes at 128^3, at a CPU-sized frame)."""
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.models import reference_object
    from bsdmg_tpu.models.mesh_sdf import bake_reference_grid, grid_scene
    from bsdmg_tpu.ops.shade import render_image_c

    sc = grid_scene(bake_reference_grid(96))
    ana = reference_object()
    cam = look_at((5.0, 2.0, -5.0), (0.0, 0.0, 0.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (64, 36), (1920.0, 1080.0))
    a = np.asarray(render_image_c(sc.csdf, sc.params, o, d, c))
    b = np.asarray(render_image_c(ana.csdf, ana.params, o, d, c))
    match = np.all(np.abs(a - b) < 2e-2, axis=-1).mean()
    assert match > 0.9, float(match)


def test_grid_scene_renderer_is_xla_march():
    """The CLI's renderer for a mesh asset is the XLA component-form march
    (no baked form exists for a grid)."""
    from bsdmg_tpu.cam import generate_rays, look_at
    from bsdmg_tpu.cli import _make_renderer
    from bsdmg_tpu.models.mesh_sdf import grid_scene
    from bsdmg_tpu.ops.pallas import compile_scene_csdf
    from bsdmg_tpu.ops.shade import render_image_c

    sc = grid_scene(_sphere_grid(32))
    assert compile_scene_csdf(sc) is None
    cam = look_at((2.5, 1.0, -2.5), (0.0, 0.0, 0.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (32, 16), (32.0, 16.0))
    got = np.asarray(_make_renderer(sc)(o, d, c))
    want = np.asarray(render_image_c(sc.csdf, sc.params, o, d, c))
    # eager vs jitted fusion: ulp-level depth differences through fd4
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_grid_scene_mesh_on_surface():
    """A baked sphere grid drives the mesh pipeline: every welded vertex
    lies on the interpolated surface, within a grid cell of the sphere."""
    from bsdmg_tpu.config import MeshGenConfig
    from bsdmg_tpu.mesh import generate_mesh
    from bsdmg_tpu.models.mesh_sdf import grid_csdf, grid_scene

    grid = _sphere_grid(48)
    sc = grid_scene(grid)
    cfg = MeshGenConfig(init_factor=8, bb_size=3.0, newton_iters=8)
    mesh = generate_mesh(sc.bind(), refine_steps=2, config=cfg, csdf=grid_csdf(grid))
    assert mesh.triangle_count > 100
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert np.abs(r - 1.0).max() < 3.0 / 47
    sd = np.asarray(sc.bind()(jnp.asarray(mesh.vertices)))
    assert np.abs(sd).max() < 5 * cfg.newton_tolerance


class TestGridCsdf:
    def test_grid_csdf_accepts_host_backed_grid(self):
        """grid_csdf/grid_sdf must coerce numpy-backed SdfGrids (a numpy
        table indexed by a tracer raises TracerArrayConversionError)."""
        import jax
        import jax.numpy as jnp

        from bsdmg_tpu.models.mesh_sdf import SdfGrid, grid_csdf, grid_sdf

        r = 9
        vals = np.random.default_rng(1).standard_normal((r, r, r)).astype(np.float32)
        grid = SdfGrid(values=vals, lo=(-1.0,) * 3, hi=(1.0,) * 3)
        f = grid_csdf(grid)
        x = jnp.linspace(-1.2, 1.2, 64)
        out = jax.jit(lambda a: f(a, a, a))(x)
        assert np.isfinite(np.asarray(out)).all()
        p = jnp.stack([x, x, x], axis=-1)
        out2 = jax.jit(grid_sdf(grid))(p)
        np.testing.assert_allclose(np.asarray(out), np.asarray(out2), atol=1e-5)
