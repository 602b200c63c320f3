"""Composable scene specs (models/compose.py): validation, param tracing,
baked-vs-traced parity, slab-cull bounds soundness, CLI integration.

The reference's scene is compiled-in CUDA (common.cu:222-226); composed
scenes are the data-driven equivalent and must behave exactly like the
built-ins on every path (oracle render, SoA render, Pallas baking, grad).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsdmg_tpu.models.compose import (
    compose_scene,
    composed_bounds,
    load_scene_spec,
)

SNOWMAN = {
    "name": "snowman",
    "root": {
        "op": "smooth_union",
        "k": 0.4,
        "children": [
            {"prim": "sphere", "center": [0.0, 0.0, 0.0], "radius": 1.0},
            {"prim": "sphere", "center": [0.0, 1.2, 0.0], "radius": 0.6},
            {"prim": "capsule", "start": [-1.5, 1.2, 0.0],
             "end": [1.5, 1.2, 0.0], "radius": 0.08},
        ],
    },
}

GADGET = {
    "root": {
        "op": "union",
        "children": [
            {
                "op": "subtract",
                "children": [
                    {"prim": "box", "size": [2.0, 1.0, 1.0]},
                    {"prim": "sphere", "center": [1.0, 0.5, 0.0], "radius": 0.7},
                ],
            },
            {
                "op": "transform",
                "offset": [0.0, 1.5, 0.0],
                "rotation": [0.9238795, 0.0, 0.0, 0.3826834],  # 45 deg about z
                "child": {
                    "op": "shell",
                    "thickness": 0.05,
                    "child": {"prim": "box", "size": [0.8, 0.8, 0.8]},
                },
            },
            {"prim": "box_skeleton", "size": [4.0, 4.0, 4.0],
             "line_width": 0.04},
        ],
    }
}


TABLE = {
    "root": {
        "op": "intersect",
        "children": [
            {"prim": "plane", "normal": [0.0, 1.0, 0.0], "offset": 0.7},
            {
                "op": "union",
                "children": [
                    {"prim": "torus", "center": [0.0, 0.6, 0.0],
                     "major_radius": 1.2, "minor_radius": 0.2},
                    {"prim": "cylinder", "center": [0.0, 0.4, 0.0],
                     "radius": 0.3, "height": 1.2},
                ],
            },
        ],
    }
}


def _points(n=512, extent=3.0, seed=0):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.uniform(-extent, extent, (n, 3)), jnp.float32)


class TestValidation:
    def test_unknown_primitive(self):
        with pytest.raises(ValueError, match="unknown primitive"):
            compose_scene({"root": {"prim": "cone"}})

    def test_unknown_operator(self):
        with pytest.raises(ValueError, match="unknown operator"):
            compose_scene({"root": {"op": "blend", "children": []}})

    def test_unary_needs_child(self):
        with pytest.raises(ValueError, match="needs a 'child'"):
            compose_scene({"root": {"op": "shell", "thickness": 0.1}})

    def test_subtract_needs_two(self):
        with pytest.raises(ValueError, match=">= 2"):
            compose_scene(
                {"root": {"op": "subtract", "children": [{"prim": "sphere"}]}}
            )

    def test_unknown_field(self):
        with pytest.raises(ValueError, match="unknown fields"):
            compose_scene({"root": {"prim": "sphere", "radii": 1.0}})

    def test_bad_vector_shape(self):
        with pytest.raises(ValueError, match="expected shape"):
            compose_scene({"root": {"prim": "sphere", "center": [1.0, 2.0]}})


class TestParams:
    def test_preorder_naming_and_defaults(self):
        scene = compose_scene(SNOWMAN)
        assert scene.name == "snowman"
        # n0 = smooth_union, n1..n3 = the three primitives
        assert float(scene.params["n0_k"]) == pytest.approx(0.4)
        assert float(scene.params["n1_radius"]) == 1.0
        assert float(scene.params["n3_radius"]) == pytest.approx(0.08)
        np.testing.assert_allclose(
            np.asarray(scene.params["n2_center"]), [0.0, 1.2, 0.0]
        )

    def test_points_and_component_forms_agree(self):
        for spec in (SNOWMAN, GADGET, TABLE):
            scene = compose_scene(spec)
            pts = _points()
            d_pts = scene.sdf(scene.params, pts)
            d_c = scene.csdf(
                scene.params, pts[:, 0], pts[:, 1], pts[:, 2]
            )
            np.testing.assert_allclose(
                np.asarray(d_pts), np.asarray(d_c), atol=1e-6
            )

    def test_gradient_flows(self):
        scene = compose_scene(SNOWMAN)
        p = jnp.asarray([[0.0, 1.9, 0.0]], jnp.float32)  # near head sphere

        def f(params):
            return jnp.sum(scene.sdf(params, p))

        g = jax.grad(f)(scene.params)
        assert abs(float(g["n2_radius"])) > 1e-3
        # growing either radius shrinks the distance
        assert float(g["n2_radius"]) < 0


class TestBakedLowering:
    def test_baked_matches_traced(self):
        from bsdmg_tpu.ops.pallas.csdf import compile_scene_csdf

        for spec in (SNOWMAN, GADGET, TABLE):
            scene = compose_scene(spec)
            baked = compile_scene_csdf(scene)
            assert baked is not None
            pts = _points(seed=1)
            d_t = scene.csdf(scene.params, pts[:, 0], pts[:, 1], pts[:, 2])
            d_b = baked(pts[:, 0], pts[:, 1], pts[:, 2])
            np.testing.assert_allclose(
                np.asarray(d_t), np.asarray(d_b), atol=1e-6
            )

    def test_baking_tracks_current_params(self):
        from bsdmg_tpu.ops.pallas.csdf import compile_scene_csdf

        scene = compose_scene(SNOWMAN)
        grown = dict(scene.params)
        grown["n1_radius"] = jnp.float32(1.5)
        baked = compile_scene_csdf(scene, grown)
        x = jnp.asarray([2.0], jnp.float32)
        z = jnp.zeros(1, jnp.float32)
        d = float(baked(x, z, z)[0])
        assert d == pytest.approx(0.5, abs=1e-3)


class TestBounds:
    @pytest.mark.parametrize("spec", [SNOWMAN, GADGET, TABLE])
    def test_surface_inside_bounds(self, spec):
        scene = compose_scene(spec)
        bb = composed_bounds(scene)
        assert bb is not None
        lo, hi, slack = np.asarray(bb[0]), np.asarray(bb[1]), bb[2]
        pts = _points(4096, extent=4.0, seed=2)
        d = np.asarray(
            scene.csdf(scene.params, pts[:, 0], pts[:, 1], pts[:, 2])
        )
        near = pts[np.abs(d) < 1e-2]
        assert near.shape[0] > 0
        assert (near >= lo - 1.1e-2).all() and (near <= hi + 1.1e-2).all()

    @pytest.mark.parametrize("spec", [SNOWMAN, GADGET, TABLE])
    def test_cull_contract_f_ge_boxdist_minus_slack(self, spec):
        """_slab_cull soundness: f(p) >= d(p, box) - slack for every p
        OUTSIDE the box (inside, the cull's |p-c| - r bound is vacuously
        negative — signed distances there are allowed to be arbitrarily
        negative)."""
        scene = compose_scene(spec)
        lo, hi, slack = composed_bounds(scene)
        lo, hi = np.asarray(lo), np.asarray(hi)
        pts = np.asarray(_points(4096, extent=8.0, seed=3))
        d = np.asarray(
            scene.csdf(
                scene.params,
                jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
                jnp.asarray(pts[:, 2]),
            )
        )
        box_d = np.linalg.norm(
            np.maximum(np.maximum(lo - pts, pts - hi), 0.0), axis=1
        )
        outside = box_d > 0.0
        assert outside.sum() > 1000
        assert (d[outside] >= box_d[outside] - slack - 1e-5).all()

    def test_primitive_exact_values(self):
        """Spot-check the analytic SDF values of torus/cylinder/plane."""
        z1 = jnp.zeros(1, jnp.float32)

        def one(spec, p):
            s = compose_scene({"root": spec})
            return float(
                s.csdf(s.params, jnp.float32([p[0]]), jnp.float32([p[1]]),
                       jnp.float32([p[2]]))[0]
            )

        torus = {"prim": "torus", "major_radius": 1.0, "minor_radius": 0.25}
        assert one(torus, (1.0, 0.0, 0.0)) == pytest.approx(-0.25, abs=1e-6)
        assert one(torus, (2.0, 0.0, 0.0)) == pytest.approx(0.75, abs=1e-6)
        assert one(torus, (0.0, 1.0, 0.0)) == pytest.approx(
            np.sqrt(2.0) - 0.25, abs=1e-6
        )

        cyl = {"prim": "cylinder", "radius": 0.5, "height": 2.0}
        assert one(cyl, (0.0, 0.0, 0.0)) == pytest.approx(-0.5, abs=1e-6)
        assert one(cyl, (1.5, 0.0, 0.0)) == pytest.approx(1.0, abs=1e-6)
        assert one(cyl, (0.0, 2.0, 0.0)) == pytest.approx(1.0, abs=1e-6)
        assert one(cyl, (1.5, 2.0, 0.0)) == pytest.approx(
            np.sqrt(2.0), abs=1e-6
        )

        # non-unit normal must be normalized
        plane = {"prim": "plane", "normal": [0.0, 2.0, 0.0], "offset": 0.5}
        assert one(plane, (0.0, 1.5, 0.0)) == pytest.approx(1.0, abs=1e-6)

    def test_intersect_prefers_bounded_child(self):
        """intersect(plane, bounded) still culls via the bounded child."""
        scene = compose_scene(TABLE)
        bb = composed_bounds(scene)
        assert bb is not None
        lo, hi = np.asarray(bb[0]), np.asarray(bb[1])
        # the union child's box: torus reach 1.4 in xz, cylinder spans
        # y in [-0.2, 1.0]
        np.testing.assert_allclose(lo, [-1.4, -0.2, -1.4], atol=1e-6)
        np.testing.assert_allclose(hi, [1.4, 1.0, 1.4], atol=1e-6)

    def test_intersection_not_degenerate(self):
        """The plane genuinely slices the solid: the intersection keeps a
        substantial interior AND removes a substantial part (regression for
        a tangent plane that culled the torus entirely)."""
        scene = compose_scene(TABLE)
        inner = compose_scene(TABLE["root"]["children"][1])
        pts = _points(8192, extent=2.0, seed=7)
        d_cut = np.asarray(
            scene.csdf(scene.params, pts[:, 0], pts[:, 1], pts[:, 2])
        )
        d_full = np.asarray(
            inner.csdf(inner.params, pts[:, 0], pts[:, 1], pts[:, 2])
        )
        kept = (d_cut < 0).sum()
        removed = ((d_full < 0) & (d_cut >= 0)).sum()
        # the removed sliver (torus tube above the plane) is thin — ~0.4%
        # of the sample box — but must be decisively non-empty
        assert kept > 50 and removed > 20

    def test_wrap_is_unbounded(self):
        scene = compose_scene(
            {"root": {"op": "wrap", "cell": [6.0, 6.0, 6.0],
                      "child": {"prim": "sphere"}}}
        )
        assert composed_bounds(scene) is None
        # scene_bounds plumbing agrees
        from bsdmg_tpu.ops.pallas.csdf import scene_bounds

        assert scene_bounds(scene) is None

    def test_subtract_uses_base_bounds(self):
        scene = compose_scene(GADGET)
        sub = GADGET["root"]["children"][0]
        base_scene = compose_scene({"root": sub["children"][0]})
        sub_scene = compose_scene({"root": sub})
        assert composed_bounds(sub_scene) == composed_bounds(base_scene)


class TestRenderIntegration:
    def test_soa_render_matches_oracle_path(self):
        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.ops.shade import render_image, render_image_c

        scene = compose_scene(SNOWMAN)
        cam = look_at((4.0, 2.0, -4.0), fov=np.pi / 4)
        o, d, c = generate_rays(cam, (64, 36), (1920.0, 1080.0))
        img_pts = render_image(scene.bind(), o, d, c)
        img_soa = render_image_c(scene.csdf, scene.params, o, d, c)
        # atol 2e-4: the fd4 normal stencil amplifies ulp-level hit-depth
        # differences between the points and planes evaluation orders
        np.testing.assert_allclose(
            np.asarray(img_pts), np.asarray(img_soa), atol=2e-4
        )

    def test_pallas_trace_matches_pure(self):
        """The Triton tile kernel (interpret mode) renders a composed scene
        like the XLA component-form march."""
        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.ops.pallas.csdf import compile_scene_csdf, scene_bounds
        from bsdmg_tpu.ops.pallas.render_triton import render_image_triton
        from bsdmg_tpu.ops.shade import render_image_c

        scene = compose_scene(SNOWMAN)
        csdf = compile_scene_csdf(scene)
        cam = look_at((4.0, 2.0, -4.0), fov=np.pi / 4)
        o, d, c = generate_rays(cam, (64, 32), (1920.0, 1080.0))
        ref = np.asarray(render_image_c(scene.csdf, scene.params, o, d, c))
        img = np.asarray(
            render_image_triton(csdf, o, d, c, bb=scene_bounds(scene),
                                interpret=True)
        )
        assert (ref.max(-1) > 0).any()
        np.testing.assert_allclose(img, ref, atol=2e-4)

    def test_cli_json_scene(self, tmp_path):
        from bsdmg_tpu.cli import _get_scene

        path = tmp_path / "snowman.json"
        path.write_text(json.dumps(SNOWMAN))
        scene = _get_scene(str(path))
        assert scene.name == "snowman"
        assert scene.spec is not None
        scene2 = _get_scene(f"spec:{path}")
        assert scene2.name == "snowman"

    def test_inverse_rendering_recovers_param(self):
        """Composed scenes are fit-able end-to-end: recover a perturbed
        sphere radius from a depth image via the differentiable renderer."""
        import optax

        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.grad.diff_render import differentiable_hit

        scene = compose_scene(
            {"root": {"prim": "sphere", "radius": 1.0}}
        )
        cam = look_at((3.0, 0.5, -3.0), fov=np.pi / 4)
        o, d, c = generate_rays(cam, (32, 24), (1920.0, 1080.0))
        from bsdmg_tpu.ops.trace import COLLISION

        t_true, hit0 = differentiable_hit(scene.sdf, scene.params, o, d, c)
        mask0 = hit0.outcome == COLLISION
        target = jnp.where(mask0, t_true, 0.0)

        params = {"n0_center": scene.params["n0_center"],
                  "n0_radius": jnp.float32(1.3)}
        opt = optax.adam(5e-2)
        state = opt.init(params)

        @jax.jit
        def step(p, s):
            def loss_fn(q):
                t, h = differentiable_hit(scene.sdf, q, o, d, c)
                both = mask0 & (h.outcome == COLLISION)
                return jnp.mean(jnp.where(both, (t - target) ** 2, 0.0))

            loss, g = jax.value_and_grad(loss_fn)(p)
            g = {k: (v if k == "n0_radius" else v * 0.0) for k, v in g.items()}
            up, s = opt.update(g, s)
            return optax.apply_updates(p, up), s, loss

        for _ in range(60):
            params, state, loss = step(params, state)
        assert abs(float(params["n0_radius"]) - 1.0) < 0.02

    def test_loss_and_grad_handles_composed_params(self):
        """The fit's training step accepts a composed scene's pytree
        (scalars + (3,)/(4,) vectors) and matches jax.value_and_grad of the
        points-path diff render."""
        import jax

        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.grad import render_image_diff, render_loss_and_grad

        scene = compose_scene(SNOWMAN)
        cam = look_at((4.0, 2.0, -4.0), fov=np.pi / 4)
        o, d, c = generate_rays(cam, (32, 16), (1920.0, 1080.0))
        target = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)

        def oracle(p):
            img = render_image_diff(scene.sdf, p, o, d, c)
            return jnp.mean((img - target) ** 2)

        ref_loss, ref_g = jax.value_and_grad(oracle)(scene.params)
        loss, g = render_loss_and_grad(
            scene.sdf, scene.params, target, o, d, c, csdf=scene.csdf,
        )
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
        for k in ref_g:
            np.testing.assert_allclose(
                np.asarray(g[k]), np.asarray(ref_g[k]), rtol=0.05, atol=1e-4,
                err_msg=k,
            )

    def test_mesh_generation(self):
        """Composed scenes drive the mesh generator (CLI mesh --scene x.json)."""
        from bsdmg_tpu.config import MeshGenConfig
        from bsdmg_tpu.mesh import generate_mesh

        scene = compose_scene(SNOWMAN)
        cfg = MeshGenConfig(init_factor=16, bb_size=5.0)
        mesh = generate_mesh(scene.bind(), 1, cfg)
        assert mesh.triangle_count > 100
        # extracted vertices sit near the composed isosurface
        v = jnp.asarray(mesh.vertices)
        dist = np.abs(np.asarray(
            scene.csdf(scene.params, v[:, 0], v[:, 1], v[:, 2])
        ))
        assert float(np.median(dist)) < 2e-2

    def test_motion_through_root_transform(self, tmp_path):
        """animate --motion drives a composed scene whose root is a
        transform node (object_center/object_rotation map onto the n0_*
        params); frames must actually move."""
        import sys

        from PIL import Image

        from bsdmg_tpu.cli import main

        spec = {
            "root": {
                "op": "transform",
                "child": {"prim": "sphere", "radius": 0.8},
            }
        }
        path = tmp_path / "orb.json"
        path.write_text(json.dumps(spec))
        # 3 frames: with 2, the samples land at t=0 and t=2.5 — half the
        # 5s cycle, where the sinusoid is back at zero offset
        argv, sys.argv = sys.argv, [
            "cli", "animate", "--scene", str(path), "--motion", "axis",
            "--frames", "3", "--width", "48", "--height", "32",
            "-o", str(tmp_path / "f"),
        ]
        try:
            main()
        finally:
            sys.argv = argv
        a = np.asarray(Image.open(tmp_path / "f_0000.png"))
        b = np.asarray(Image.open(tmp_path / "f_0001.png"))
        assert not np.array_equal(a, b)

    def test_json_round_trip(self, tmp_path):
        path = tmp_path / "g.json"
        path.write_text(json.dumps(GADGET))
        scene = load_scene_spec(path)
        assert scene.name == "g"  # falls back to the file stem
        pts = _points(64, seed=4)
        ref = compose_scene(GADGET)
        np.testing.assert_allclose(
            np.asarray(scene.csdf(scene.params, pts[:, 0], pts[:, 1], pts[:, 2])),
            np.asarray(ref.csdf(ref.params, pts[:, 0], pts[:, 1], pts[:, 2])),
        )
