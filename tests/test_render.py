"""Tracer, camera and golden-render tests against the NumPy oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from bsdmg_tpu.cam import Camera, generate_rays, look_at
from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.models import reference_render_scene, sphere_scene
from bsdmg_tpu.ops import (
    COLLISION,
    DEPTH_LIMIT,
    STEP_LIMIT,
    render_image,
    shade_hits,
    sphere_trace,
    to_rgba8,
)
from bsdmg_tpu.ops.shade import aces_tonemap

SPHERE = sphere_scene(1.0).bind()


class TestTracer:
    def test_head_on_hit(self):
        o = jnp.asarray([[-3.0, 0.0, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])
        hit = sphere_trace(SPHERE, o, d)
        assert int(hit.outcome[0]) == COLLISION
        assert abs(float(hit.depth[0]) - 2.0) < 2e-3
        np.testing.assert_allclose(hit.position[0], [-1.0, 0, 0], atol=2e-3)

    def test_miss_depth_limit(self):
        o = jnp.asarray([[-3.0, 5.0, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])
        hit = sphere_trace(SPHERE, o, d)
        assert int(hit.outcome[0]) == DEPTH_LIMIT
        assert float(hit.depth[0]) > 500.0

    def test_step_limit(self):
        # constant SDF of 0.01: never within collision eps, advances 0.01/step,
        # so a 64-step budget exhausts at depth 0.64 with outcome StepLimit
        const = lambda p: jnp.full(p.shape[:-1], 0.01)
        o = jnp.asarray([[0.0, 0.0, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])
        hit = sphere_trace(const, o, d, config=MarchConfig(step_limit=64))
        assert int(hit.outcome[0]) == STEP_LIMIT
        assert int(hit.steps[0]) == 64
        assert abs(float(hit.depth[0]) - 0.64) < 1e-5

    def test_batch_against_oracle(self):
        rng = np.random.RandomState(0)
        origins = rng.uniform(-3, 3, (32, 3)).astype(np.float32)
        origins[:, 0] -= 4.0
        dirs = rng.normal(size=(32, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        cones = rng.uniform(0.0, 0.002, 32).astype(np.float32)

        hit = sphere_trace(SPHERE, jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(cones))

        sd = lambda p: np.linalg.norm(p) - 1.0
        for i in range(32):
            outcome, pos, depth, steps = oracle.ray_march(sd, origins[i], dirs[i], cones[i])
            assert int(hit.outcome[i]) == outcome, i
            assert abs(float(hit.depth[i]) - depth) < 1e-2, i
            assert int(hit.steps[i]) == steps, i

    def test_cone_radius_widens_collision(self):
        # ray passing 0.05 above the unit sphere: a zero cone misses, but a
        # 0.05/unit cone's threshold (~0.5 at depth 10) registers a collision
        o = jnp.asarray([[-10.0, 1.05, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])
        thin = sphere_trace(SPHERE, o, d, 0.0)
        wide = sphere_trace(SPHERE, o, d, 0.05)
        assert int(thin.outcome[0]) == DEPTH_LIMIT
        assert int(wide.outcome[0]) == COLLISION


class TestCamera:
    def test_look_at_basis(self):
        cam = look_at((5.0, 2.0, -5.0))
        f = np.asarray(cam.forward)
        np.testing.assert_allclose(
            f, -np.asarray([5.0, 2.0, -5.0]) / np.linalg.norm([5.0, 2.0, -5.0]), atol=1e-6
        )
        for a, b in ((cam.forward, cam.up), (cam.forward, cam.right), (cam.up, cam.right)):
            assert abs(float(jnp.dot(a, b))) < 1e-6

    def test_rays_match_oracle(self):
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        W, H = 16, 9
        origins, dirs, cone = generate_rays(cam, (W, H), (W, H))
        assert dirs.shape == (H, W, 3)
        pos = np.asarray(cam.position)
        fwd, up, right = map(np.asarray, (cam.forward, cam.up, cam.right))
        for y in (0, 4, 8):
            for x in (0, 7, 15):
                od = oracle.camera_ray(x, y, pos, fwd, up, right, np.pi / 4, W, H, W, H)
                np.testing.assert_allclose(np.asarray(dirs[y, x]), od, atol=1e-6)
                oc = oracle.pixel_cone_radius(x, y, pos, fwd, up, right, np.pi / 4, W, H, W, H)
                assert abs(float(cone[y, x]) - oc) < 1e-6

    def test_screen_aspect_factor(self):
        # when screen and texture aspect differ, width_factor != 1 changes x rays
        cam = look_at((5.0, 2.0, -5.0))
        _, d1, _ = generate_rays(cam, (16, 9), (16.0, 9.0))
        _, d2, _ = generate_rays(cam, (16, 9), (32.0, 9.0))
        assert not np.allclose(np.asarray(d1), np.asarray(d2))


class TestShading:
    def test_aces_matches_oracle(self):
        rng = np.random.RandomState(1)
        rgb = rng.uniform(0, 1.5, (64, 3)).astype(np.float32)
        ours = np.asarray(aces_tonemap(jnp.asarray(rgb)))
        for i in range(64):
            np.testing.assert_allclose(ours[i], oracle.aces(rgb[i]), atol=1e-5)

    def test_rgba8(self):
        rgb = jnp.asarray([[0.0, 0.5, 1.0], [-1.0, 2.0, 0.999]])
        out = np.asarray(to_rgba8(rgb))
        np.testing.assert_array_equal(out[0], [0, 127, 255, 255])
        np.testing.assert_array_equal(out[1], [0, 255, 254, 255])


class TestGoldenRender:
    @pytest.mark.parametrize("use_grad_normal", [False, True])
    def test_reference_scene_64px(self, use_grad_normal):
        """End-to-end 64x36 render of the reference scene vs the oracle."""
        scene = reference_render_scene().bind()
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        W, H = 64, 36
        origins, dirs, cone = generate_rays(cam, (W, H), (1920.0, 1080.0))
        img = render_image(scene, origins, dirs, cone, use_grad_normal=use_grad_normal)
        img = np.asarray(img)

        pos = np.asarray(cam.position)
        fwd, up, right = map(np.asarray, (cam.forward, cam.up, cam.right))
        golden = oracle.render(W, H, pos, fwd, up, right, np.pi / 4,
                               screen_w=1920.0, screen_h=1080.0)

        # float32 vs float64 tracing can disagree on a few silhouette pixels;
        # require near-exact match on >99% of pixels and bounded mean error.
        diff = np.abs(img - golden).max(axis=-1)
        assert np.mean(diff < 2e-2) > 0.99, f"mismatched pixels: {(diff >= 2e-2).sum()}"
        assert diff.mean() < 2e-3


class TestCachedGolden:
    def test_reference_scene_256px_cached(self):
        """The Triton tile kernel (slab cull + tile split + fused shade,
        interpret mode) vs the committed 256x144 oracle render — the
        full-resolution regression pin that is too slow to oracle-render
        per run (tests/golden/generate.py regenerates it)."""
        import os

        from bsdmg_tpu.ops.pallas import compile_scene_csdf
        from bsdmg_tpu.ops.pallas.csdf import compile_scene_split, scene_bounds
        from bsdmg_tpu.ops.pallas.render_triton import render_image_triton

        path = os.path.join(
            os.path.dirname(__file__), "golden", "render_256x144.npz"
        )
        golden = np.load(path)["image"]
        assert golden.shape == (144, 256, 3)

        scene = reference_render_scene()
        csdf = compile_scene_csdf(scene)
        bb = scene_bounds(scene)
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        origins, dirs, cone = generate_rays(cam, (256, 144), (1920.0, 1080.0))
        img = np.asarray(render_image_triton(
            csdf, origins, dirs, cone, bb=bb, split=compile_scene_split(scene),
            interpret=True,
        ))

        # float32 kernel vs float64 oracle: near-exact away from silhouettes
        diff = np.abs(img - golden).max(axis=-1)
        assert np.mean(diff < 2e-2) > 0.995, f"mismatched: {(diff >= 2e-2).sum()}"
        assert diff.mean() < 1e-3


class TestReferenceTargetOperatingPoint:
    def test_2560x1440_tile_matches_oracle(self):
        """The reference's actual render target is 2560x1440
        (src/renderer/mod.rs:10) — a smaller per-pixel cone radius than the
        1080p goldens. Pin that operating point with a 64x36 tile at the
        image center (object silhouette in frame): full-resolution ray/cone
        math, tile-sized cost, the Triton tile kernel (interpret) vs the
        NumPy oracle's tile render."""
        from bsdmg_tpu.ops.pallas import compile_scene_csdf
        from bsdmg_tpu.ops.pallas.csdf import scene_bounds
        from bsdmg_tpu.ops.pallas.render_triton import render_image_triton

        W, H = 2560, 1440
        TW, TH = 64, 36
        x0, y0 = (W - TW) // 2, (H - TH) // 2

        scene = reference_render_scene()
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        origins, dirs, cone = generate_rays(cam, (W, H), (float(W), float(H)))
        o = origins[y0 : y0 + TH, x0 : x0 + TW]
        d = dirs[y0 : y0 + TH, x0 : x0 + TW]
        c = cone[y0 : y0 + TH, x0 : x0 + TW]
        # the tile's cone radius is the full-res operating point: ~0.75x the
        # 1080p-golden cone (which measures ~7.7e-4 at the image center)
        assert 5.0e-4 < float(jnp.max(c)) < 6.5e-4

        img = np.asarray(
            render_image_triton(
                compile_scene_csdf(scene), o, d, c,
                bb=scene_bounds(scene), interpret=True,
            )
        )

        pos = np.asarray(cam.position)
        fwd, up, right = map(np.asarray, (cam.forward, cam.up, cam.right))
        golden = oracle.render(
            W, H, pos, fwd, up, right, np.pi / 4,
            screen_w=float(W), screen_h=float(H),
            x0=x0, y0=y0, tile_w=TW, tile_h=TH,
        )
        assert golden.shape == (TH, TW, 3)

        diff = np.abs(img - golden).max(axis=-1)
        assert np.mean(diff < 2e-2) > 0.99, f"mismatched: {(diff >= 2e-2).sum()}"
        assert diff.mean() < 2e-3
