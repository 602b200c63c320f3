"""Differentiable rendering: AD pixel gradients vs finite differences.

The BASELINE north-star acceptance test: pixel gradients w.r.t. SDF params
must be allclose to finite differences (away from silhouettes, where the
rendering function is genuinely discontinuous).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MarchConfig
from bsdmg_tpu.grad import render_image_diff, render_loss_and_grad
from bsdmg_tpu.models import reference_object, sphere_scene
from bsdmg_tpu.ops.trace import COLLISION, sphere_trace


def _setup(w=24, h=16):
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    return cam, generate_rays(cam, (w, h), (float(w), float(h)))


class TestImplicitDepthGradient:
    def test_sphere_radius_depth_gradient(self):
        """Analytic check: head-on ray at a sphere, d t / d r = -1."""
        scene = sphere_scene(1.0)
        o = jnp.asarray([[-5.0, 0.0, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])

        from bsdmg_tpu.grad import differentiable_hit

        def depth_of(params):
            t, _ = differentiable_hit(scene.sdf, params, o, d, 0.0)
            return t[0]

        g = jax.grad(depth_of)(scene.params)
        assert abs(float(g["radius"]) + 1.0) < 1e-3

    def test_depth_gradient_matches_fd(self):
        scene = reference_object()
        cam, (origins, dirs, cone) = _setup()
        from bsdmg_tpu.grad import differentiable_hit

        def mean_depth(params):
            t, hit = differentiable_hit(scene.sdf, params, origins, dirs, cone)
            mask = (hit.outcome == COLLISION).astype(jnp.float32)
            return jnp.sum(t * mask) / jnp.sum(mask)

        g = jax.grad(mean_depth)(scene.params)

        eps = 1e-3
        for key in ("sphere_radius", "smooth_k"):
            p_plus = dict(scene.params)
            p_plus[key] = scene.params[key] + eps
            p_minus = dict(scene.params)
            p_minus[key] = scene.params[key] - eps
            fd = (float(mean_depth(p_plus)) - float(mean_depth(p_minus))) / (2 * eps)
            ad = float(g[key])
            assert abs(ad - fd) < 5e-2 * max(1.0, abs(fd)), (key, ad, fd)


class TestPixelGradients:
    def test_pixel_grads_vs_fd(self):
        """Mean stable-pixel intensity gradient: AD vs central differences."""
        scene = reference_object()
        cam, (origins, dirs, cone) = _setup(24, 16)

        base_hit = sphere_trace(scene.bind(), origins, dirs, cone)
        stable = base_hit.outcome == COLLISION

        def loss(params):
            img = render_image_diff(scene.sdf, params, origins, dirs, cone)
            return jnp.sum(img * stable[..., None]) / jnp.sum(stable)

        ad = jax.grad(loss)(scene.params)

        eps = 1e-3
        for key in ("sphere_radius", "smooth_k", "skeleton_line_width"):
            p_plus = dict(scene.params)
            p_plus[key] = scene.params[key] + eps
            p_minus = dict(scene.params)
            p_minus[key] = scene.params[key] - eps
            fd = (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)
            val = float(ad[key])
            denom = max(abs(fd), 1e-3)
            assert abs(val - fd) / denom < 0.1, (key, val, fd)

    def test_skeleton_center_gradient_vector(self):
        scene = reference_object()
        cam, (origins, dirs, cone) = _setup(16, 12)
        base_hit = sphere_trace(scene.bind(), origins, dirs, cone)
        stable = base_hit.outcome == COLLISION

        def loss(params):
            img = render_image_diff(scene.sdf, params, origins, dirs, cone)
            return jnp.sum(img * stable[..., None]) / jnp.sum(stable)

        ad = jax.grad(loss)(scene.params)["skeleton_center"]
        eps = 1e-3
        for axis in range(3):
            delta = jnp.zeros(3).at[axis].set(eps)
            p_plus = dict(scene.params)
            p_plus["skeleton_center"] = scene.params["skeleton_center"] + delta
            p_minus = dict(scene.params)
            p_minus["skeleton_center"] = scene.params["skeleton_center"] - delta
            fd = (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)
            val = float(ad[axis])
            assert abs(val - fd) < 0.1 * max(1.0, abs(fd)), (axis, val, fd)


class TestInverseRendering:
    def test_gradient_descent_recovers_radius(self):
        """Fit the sphere radius from a target depth map.

        Color-only L2 has no gradient across the collision/miss step (the
        silhouette is a true discontinuity of the render function), so the
        canonical well-posed inverse problem is depth supervision over pixels
        that collide under both hypotheses.
        """
        from bsdmg_tpu.grad import differentiable_hit

        scene = sphere_scene(1.0)
        cam = look_at((0.0, 0.5, -4.0), fov=np.pi / 4)
        origins, dirs, cone = generate_rays(cam, (24, 24), (24.0, 24.0))

        t_target, hit_target = differentiable_hit(
            scene.sdf, {"radius": jnp.float32(1.0)}, origins, dirs, cone
        )
        params = {"radius": jnp.float32(1.25)}
        _, hit_init = differentiable_hit(scene.sdf, params, origins, dirs, cone)
        stable = (hit_target.outcome == COLLISION) & (hit_init.outcome == COLLISION)
        t_target = jax.lax.stop_gradient(t_target)

        def loss_fn(p):
            t, hit = differentiable_hit(scene.sdf, p, origins, dirs, cone)
            mask = stable & (hit.outcome == COLLISION)
            err = (t - t_target) * mask
            return jnp.sum(err**2) / jnp.maximum(jnp.sum(mask), 1)

        lr = 0.2
        for _ in range(60):
            loss, g = jax.value_and_grad(loss_fn)(params)
            params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
        assert abs(float(params["radius"]) - 1.0) < 0.01, float(params["radius"])


class TestComponentDiffRender:
    """The SoA differentiable render must agree with the points path in both
    the image and the parameter gradients."""

    def _setup(self, w=96, h=64):
        from bsdmg_tpu.cam import generate_rays, look_at
        from bsdmg_tpu.models import reference_render_scene

        scene = reference_render_scene()
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        o, d, c = generate_rays(cam, (w, h), (1920.0, 1080.0))
        return scene, o, d, c

    def test_image_matches_points_path(self):
        from bsdmg_tpu.grad import render_image_diff

        scene, o, d, c = self._setup()
        a = render_image_diff(scene.sdf, scene.params, o, d, c)
        b = render_image_diff(scene.sdf, scene.params, o, d, c, csdf=scene.csdf)
        diff = np.abs(np.asarray(a) - np.asarray(b))
        # identical march semantics; tiny float reassociation differences
        assert (diff.max(-1) > 1e-3).mean() < 0.005
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0.25)

    def test_gradients_match_points_path(self):
        import jax
        import jax.numpy as jnp

        from bsdmg_tpu.grad import render_image_diff

        scene, o, d, c = self._setup(48, 32)
        target = jnp.zeros((32, 48, 3), jnp.float32)

        def loss(p, csdf):
            img = render_image_diff(scene.sdf, p, o, d, c, csdf=csdf)
            return jnp.mean((img - target) ** 2)

        ga = jax.grad(lambda p: loss(p, None))(scene.params)
        gb = jax.grad(lambda p: loss(p, scene.csdf))(scene.params)
        for k in ga:
            np.testing.assert_allclose(
                np.asarray(ga[k]), np.asarray(gb[k]), rtol=0.05, atol=1e-4,
                err_msg=k,
            )


def test_gradients_match_fd_over_random_params():
    """Stable-pixel-loss gradients (SoA component path) vs central finite
    differences at a NON-default parameter point — the BASELINE north-star
    check off the defaults. Silhouette pixels are excluded: the
    collision/miss outcome flip is a step discontinuity where FD and AD
    legitimately disagree (SURVEY §7 hard-part 3)."""
    from bsdmg_tpu.models import reference_render_scene

    scene = reference_render_scene()
    params = dict(scene.params)
    params["sphere_radius"] = jnp.float32(1.3)
    params["smooth_k"] = jnp.float32(0.7)

    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (48, 32), (1920.0, 1080.0))

    base = sphere_trace(scene.bind(params), o, d, c)

    def loss(p, mask):
        img = render_image_diff(scene.sdf, p, o, d, c, csdf=scene.csdf)
        return jnp.sum(img * mask) / jnp.sum(mask)

    for key in ("sphere_radius", "smooth_k", "skeleton_line_width"):
        eps = 1e-3
        pp = dict(params); pp[key] = params[key] + eps
        pm = dict(params); pm[key] = params[key] - eps
        # exclude pixels whose OUTCOME flips under the perturbation, and
        # pixels whose hit jumps between surfaces (frame <-> object): both
        # are step discontinuities where FD scales ~1/eps and AD is the
        # one-sided smooth derivative
        hp_ = sphere_trace(scene.bind(pp), o, d, c)
        hm_ = sphere_trace(scene.bind(pm), o, d, c)
        mask = (
            (base.outcome == COLLISION)
            & (hp_.outcome == COLLISION)
            & (hm_.outcome == COLLISION)
            & (jnp.abs(hp_.depth - hm_.depth) < 0.05)
        ).astype(jnp.float32)[..., None]
        fd = (float(loss(pp, mask)) - float(loss(pm, mask))) / (2 * eps)
        got = float(jax.grad(lambda p: loss(p, mask))(params)[key])
        assert got == pytest.approx(fd, rel=0.1, abs=2e-3), (key, got, fd)


def test_diff_render_slab_cull_matches_uncull():
    """The slab cull inside the differentiable render (``bb``) must not
    change the image or the gradients: culled rays provably cannot collide,
    and the march is stopped, so gradients flow through the IFT
    reattachment only."""
    from bsdmg_tpu.grad.diff_render import _render_image_diff_c
    from bsdmg_tpu.models import reference_render_scene
    from bsdmg_tpu.ops.pallas.csdf import scene_bounds

    scene = reference_render_scene()
    params = dict(scene.params)
    params["sphere_radius"] = jnp.float32(1.2)
    lo, hi, slack = scene_bounds(scene)
    bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
    cam = look_at((6.0, 3.0, -6.0), fov=np.pi / 2.5)  # wide: many rays cull
    o, d, c = generate_rays(cam, (64, 32), (1920.0, 1080.0))

    def img_fn(p, box):
        return _render_image_diff_c(scene.csdf, p, o, d, c, bb=box)

    a = np.asarray(img_fn(params, None))
    b = np.asarray(img_fn(params, bb))
    np.testing.assert_allclose(a, b, atol=1e-5)

    ga = jax.grad(lambda p: jnp.sum(img_fn(p, None)))(params)
    gb = jax.grad(lambda p: jnp.sum(img_fn(p, bb)))(params)
    for k in ga:
        np.testing.assert_allclose(
            np.asarray(ga[k]), np.asarray(gb[k]), rtol=1e-4, atol=1e-5, err_msg=k
        )


def test_loss_and_grad_matches_value_and_grad():
    """``render_loss_and_grad`` (the fit's training step) == an explicit
    ``jax.value_and_grad`` of the differentiable render's L2 loss, at a
    non-default parameter point with a non-trivial target."""
    from bsdmg_tpu.models import reference_render_scene

    scene = reference_render_scene()
    params = {
        k: v
        for k, v in scene.params.items()
        if k not in ("object_center", "object_rotation")
    }
    params["sphere_radius"] = jnp.float32(1.15)
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (64, 32), (1920.0, 1080.0))
    rng = np.random.default_rng(1)
    target = jnp.asarray(rng.uniform(0, 1, (32, 64, 3)), jnp.float32)

    def loss_fn(p):
        img = render_image_diff(scene.sdf, p, o, d, c, csdf=scene.csdf)
        return jnp.mean((img - target) ** 2)

    ref_loss, ref_g = jax.value_and_grad(loss_fn)(params)
    loss, g = jax.jit(
        lambda p: render_loss_and_grad(scene.sdf, p, target, o, d, c, csdf=scene.csdf)
    )(params)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for k in ref_g:
        np.testing.assert_allclose(
            np.asarray(g[k]), np.asarray(ref_g[k]), rtol=1e-4, atol=1e-7,
            err_msg=k,
        )


class TestSilhouetteAwareGradients:
    """The envelope-theorem closest-approach loss (grad/edge.py): boundary
    gradients for outcome-flipping perturbations that pure IFT cannot see.

    The photometric-only AD gradient flips sign vs the true loss slope
    beyond r ~ 1.15. The edge term
    must extend the usable basin to at least +-25% (and is probed at +-50%).
    """

    W, H = 96, 54

    @classmethod
    def _setup(cls):
        from bsdmg_tpu.models import reference_render_scene
        from bsdmg_tpu.ops.pallas.csdf import scene_bounds

        scene = reference_render_scene()
        cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
        origins, dirs, cone = generate_rays(
            cam, (cls.W, cls.H), (1920.0, 1080.0)
        )
        true_params = {
            k: v
            for k, v in scene.params.items()
            if k not in ("object_center", "object_rotation")
        }
        lo, hi, slack = scene_bounds(scene)
        bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
        target = jax.lax.stop_gradient(
            render_image_diff(
                scene.sdf, true_params, origins, dirs, cone,
                csdf=scene.csdf, bb=bb,
            )
        )
        return scene, origins, dirs, cone, true_params, bb, target

    @pytest.mark.parametrize("factor", [0.5, 0.75, 1.25, 1.5])
    def test_gradient_sign_across_extended_basin(self, factor):
        """d(loss)/d(radius) must point back toward the truth for radius
        perturbations far outside the photometric-only basin."""
        scene, o, d, c, true_params, bb, target = self._setup()
        p = dict(true_params)
        p["sphere_radius"] = p["sphere_radius"] * factor
        _, g = render_loss_and_grad(
            scene.sdf, p, target, o, d, c, csdf=scene.csdf, bb=bb,
            edge_weight=1.0,
        )
        gr = float(g["sphere_radius"])
        if factor > 1.0:
            assert gr > 0, f"gradient {gr} should push radius down at {factor}x"
        else:
            assert gr < 0, f"gradient {gr} should push radius up at {factor}x"

    def test_edge_loss_cull_invariant(self):
        """The edge-aware loss and its gradient are the same with and
        without the slab cull: culled rays miss in the render and in the
        target, so they carry no closest-approach term either way."""
        scene, o, d, c, true_params, bb, target = self._setup()
        p = dict(true_params)
        p["sphere_radius"] = p["sphere_radius"] * 1.25
        ref_loss, ref_g = render_loss_and_grad(
            scene.sdf, p, target, o, d, c, csdf=scene.csdf, edge_weight=1.0,
        )
        loss, g = render_loss_and_grad(
            scene.sdf, p, target, o, d, c, csdf=scene.csdf, bb=bb,
            edge_weight=1.0,
        )
        assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
        for k in ref_g:
            np.testing.assert_allclose(
                np.asarray(g[k]), np.asarray(ref_g[k]), rtol=1e-3, atol=1e-6,
                err_msg=k,
            )

    def test_edge_weight_zero_is_photometric_loss(self):
        """edge_weight=0 must be bit-identical to the plain photometric
        path (the edge machinery is strictly opt-in)."""
        scene, o, d, c, true_params, bb, target = self._setup()
        p = dict(true_params)
        p["sphere_radius"] = p["sphere_radius"] * 1.1
        l0, g0 = render_loss_and_grad(
            scene.sdf, p, target, o, d, c, csdf=scene.csdf, bb=bb,
        )
        l1, g1 = render_loss_and_grad(
            scene.sdf, p, target, o, d, c, csdf=scene.csdf, bb=bb,
            edge_weight=0.0,
        )
        assert float(l0) == float(l1)
        for k in g0:
            np.testing.assert_array_equal(np.asarray(g0[k]), np.asarray(g1[k]))

    def test_joint_fit_recovers_25pct_perturbation(self):
        """A 25% radius perturbation (plus
        30% in smooth_k and line width) is jointly recovered by adam on the
        edge-aware loss."""
        import optax

        scene, o, d, c, true_params, bb, target = self._setup()
        params = dict(true_params)
        params["sphere_radius"] = params["sphere_radius"] * 1.25
        params["smooth_k"] = params["smooth_k"] * 0.7
        params["skeleton_line_width"] = params["skeleton_line_width"] * 1.3

        opt = optax.adam(2e-2)
        opt_state = opt.init(params)
        for _ in range(50):
            _, g = render_loss_and_grad(
                scene.sdf, params, target, o, d, c, csdf=scene.csdf, bb=bb,
                edge_weight=1.0,
            )
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
        assert abs(float(params["sphere_radius"]) - 1.0) < 0.05
        assert abs(float(params["skeleton_line_width"]) - 0.1) < 0.02
