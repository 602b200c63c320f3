"""The Triton render kernel (interpreter mode on CPU) against the XLA
march, its lowering to Triton for CUDA, the backend choice, and the baked
component-form scenes it renders."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import box_scene, reference_render_scene, sphere_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import compile_scene_split, scene_bounds
from bsdmg_tpu.ops.pallas.render_triton import render_image_triton
from bsdmg_tpu.ops.shade import render_image_c

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _rays(scene_cam=(5.0, 2.0, -5.0), w=64, h=24):
    cam = look_at(scene_cam, fov=np.pi / 4)
    return generate_rays(cam, (w, h), (1920.0, 1080.0))


def _scene(name):
    if name.endswith(".json"):
        from bsdmg_tpu.models.compose import load_scene_spec

        return load_scene_spec(os.path.join(EXAMPLES, name))
    return {
        "reference_render_scene": reference_render_scene,
        "sphere": lambda: sphere_scene(1.0),
        "box": lambda: box_scene((2.0, 1.0, 0.5)),
    }[name]()


def _xla(scene, o, d, c):
    """The XLA march of the param-traced scene (of the baked one for scenes
    that have no param-traced form)."""
    baked = compile_scene_csdf(scene)
    cfn = scene.csdf or (lambda _, x, y, z: baked(x, y, z))
    return np.asarray(jax.jit(
        lambda o_, d_, c_: render_image_c(cfn, scene.params, o_, d_, c_)
    )(o, d, c))


class TestCsdf:
    @pytest.mark.parametrize(
        "scene_fn", [reference_render_scene, lambda: sphere_scene(1.0), lambda: box_scene((2.0, 1.0, 0.5))]
    )
    def test_matches_stacked_sdf(self, scene_fn):
        scene = scene_fn()
        csdf = compile_scene_csdf(scene)
        assert csdf is not None
        rng = np.random.RandomState(0)
        p = rng.uniform(-4, 4, (8, 128, 3)).astype(np.float32)
        ours = np.asarray(csdf(jnp.asarray(p[..., 0]), jnp.asarray(p[..., 1]), jnp.asarray(p[..., 2])))
        ref = np.asarray(scene.bind()(jnp.asarray(p)))
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_bounds_contain_surface(self):
        scene = reference_render_scene()
        bb = scene_bounds(scene)
        lo, hi = np.asarray(bb[0]), np.asarray(bb[1])
        # sample surface-ish points via the sdf: points with |sd| small
        rng = np.random.RandomState(1)
        p = rng.uniform(-3.5, 3.5, (8192, 3)).astype(np.float32)
        sd = np.asarray(scene.bind()(jnp.asarray(p)))
        # all interior points (sd <= 0) lie inside the bound, and near-surface
        # points lie within their own distance of it
        inside = p[sd <= 0]
        assert len(inside) > 0
        assert (inside >= lo - 1e-5).all() and (inside <= hi + 1e-5).all()
        near = p[np.abs(sd) < 0.05]
        assert (near >= lo - 0.05 - 1e-5).all() and (near <= hi + 0.05 + 1e-5).all()

    def test_unknown_scene_returns_none(self):
        from bsdmg_tpu.models.scenes import Scene

        dummy = Scene("custom", lambda q, p: jnp.zeros(p.shape[:-1]), {})
        assert compile_scene_csdf(dummy) is None


class TestPallasRender:
    @pytest.mark.parametrize(
        "name",
        ["reference_render_scene", "sphere", "box", "snowman.json",
         "gadget.json", "mushroom.json"],
    )
    def test_matches_pure_render(self, name):
        """Kernel (slab cull + tile split + fused shade) == the XLA march."""
        scene = _scene(name)
        cam = (5.0, 2.0, -5.0) if name == "reference_render_scene" else (4.0, 2.0, -4.0)
        o, d, c = _rays(cam)
        ref = _xla(scene, o, d, c)
        img = np.asarray(render_image_triton(
            compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene),
            split=compile_scene_split(scene), interpret=True,
        ))
        assert (ref.max(-1) > 0).mean() > 0.05  # something is in view
        diff = np.abs(img - ref).max(-1)
        assert np.mean(diff < 2e-2) == 1.0
        assert diff.mean() < 1e-4

    @pytest.mark.parametrize("hw", [(37, 100), (9, 17), (8, 16), (1, 3)])
    def test_non_tile_aligned_shapes(self, hw):
        """Ragged sizes pad to whole 8x16 tiles and crop back."""
        h, w = hw
        scene = sphere_scene(1.0)
        o, d, c = _rays((0.0, 0.5, -3.0), w=w, h=h)
        img = np.asarray(render_image_triton(
            compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene),
            interpret=True,
        ))
        assert img.shape == (h, w, 3)
        np.testing.assert_allclose(img, _xla(scene, o, d, c), atol=1e-4)

    def test_bb_skip_safety(self):
        """The slab cull must never change a pixel vs no cull."""
        scene = reference_render_scene()
        csdf = compile_scene_csdf(scene)
        # wide fov so plenty of rays miss the bb
        cam = look_at((6.0, 3.0, -6.0), fov=np.pi / 2.5)
        o, d, c = generate_rays(cam, (64, 32), (1920.0, 1080.0))
        a = np.asarray(render_image_triton(
            csdf, o, d, c, bb=scene_bounds(scene), interpret=True))
        b = np.asarray(render_image_triton(csdf, o, d, c, interpret=True))
        np.testing.assert_allclose(a, b, atol=1e-5)


class TestTritonLowering:
    @pytest.mark.parametrize("name", ["reference_render_scene", "mandelbulb"])
    def test_lowers_to_triton_for_cuda(self, name):
        """Every primitive the kernel uses has a Triton lowering: the jitted
        render lowers for CUDA here, with no GPU, into one Triton call
        (``jnp.arccos``/``jnp.arctan2`` of the mandelbulb included)."""
        from jax import export

        from bsdmg_tpu.models import get_scene

        scene = get_scene(name)
        csdf = compile_scene_csdf(scene)
        bb, split = scene_bounds(scene), compile_scene_split(scene)
        o, d, c = _rays(w=32, h=16)
        f = jax.jit(lambda o_, d_, c_: render_image_triton(
            csdf, o_, d_, c_, bb=bb, split=split,
        ))
        exp = export.export(
            f, platforms=["cuda"],
            disabled_checks=[
                export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
            ],
        )(o, d, c)
        assert exp.mlir_module().count("__gpu$xla.gpu.triton") == 1


class TestBackendChoice:
    @pytest.mark.parametrize(
        "platform,expect", [("gpu", True), ("cpu", False), ("METAL", False)]
    )
    def test_use_render_kernel(self, monkeypatch, platform, expect):
        from bsdmg_tpu import backend

        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert backend.use_render_kernel() is expect


@pytest.mark.gpu
def test_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel vs the XLA march at 1920x1080."""
    scene = reference_render_scene()
    o, d, c = _rays(w=1920, h=1080)
    with jax.default_matmul_precision("highest"):
        ref = _xla(scene, o, d, c)
    img = np.asarray(render_image_triton(
        compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene),
        split=compile_scene_split(scene),
    ))
    diff = np.abs(img - ref).max(-1)
    assert np.mean(diff < 2e-2) >= 0.995 and diff.mean() < 1e-3


def test_mandelbulb_csdf_matches_scene():
    from bsdmg_tpu.models import mandelbulb_scene

    scene = mandelbulb_scene()
    csdf = compile_scene_csdf(scene)
    assert csdf is not None
    rng = np.random.RandomState(3)
    p = rng.uniform(-1.5, 1.5, (8, 128, 3)).astype(np.float32)
    ours = np.asarray(csdf(jnp.asarray(p[..., 0]), jnp.asarray(p[..., 1]), jnp.asarray(p[..., 2])))
    ref = np.asarray(scene.bind()(jnp.asarray(p)))
    # the fractal iteration amplifies float reassociation between the stacked
    # and component forms near the escape boundary; 5e-4 is float32-equivalent
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    # param-traced component twin agrees too
    twin = np.asarray(scene.csdf(scene.params, jnp.asarray(p[..., 0]), jnp.asarray(p[..., 1]), jnp.asarray(p[..., 2])))
    np.testing.assert_allclose(twin, ref, atol=1e-3)
    # bounds contain the surface
    bb = scene_bounds(scene)
    assert bb is not None
    sd = ref
    inside = p[sd <= 0]
    if len(inside):
        assert (inside >= np.asarray(bb[0]) - 1e-5).all()
        assert (inside <= np.asarray(bb[1]) + 1e-5).all()


def test_csdf_parity_over_random_params():
    """Both component forms (baked compiler + param-traced twin) must match
    the points API for NON-default parameters — catches bugs that the
    default-param goldens cannot see (e.g. factorization assumptions)."""
    from bsdmg_tpu.models.scenes import Scene, _sd_obj, _sd_obj_c, default_object_params
    from bsdmg_tpu.ops.pallas.csdf import reference_object_csdf

    rng = np.random.RandomState(11)
    pts = rng.uniform(-4, 4, (2048, 3)).astype(np.float32)
    x, y, z = (jnp.asarray(pts[:, a]) for a in range(3))

    for trial in range(5):
        params = default_object_params()
        params = dict(
            params,
            skeleton_center=jnp.asarray(rng.uniform(-1, 1, 3), jnp.float32),
            skeleton_size=jnp.asarray(rng.uniform(0.3, 3.5, 3), jnp.float32),
            skeleton_line_width=jnp.float32(rng.uniform(0.02, 0.3)),
            sphere_radius=jnp.float32(rng.uniform(0.3, 2.0)),
            smooth_k=jnp.float32(rng.uniform(0.1, 1.0)),
        )
        ref = np.asarray(_sd_obj(params, jnp.asarray(pts)))
        twin = np.asarray(_sd_obj_c(params, x, y, z))
        np.testing.assert_allclose(twin, ref, atol=2e-5, err_msg=f"twin trial {trial}")
        baked = reference_object_csdf(params)
        got = np.asarray(baked(x, y, z))
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=f"baked trial {trial}")


def test_split_specialization_matches_unsplit():
    """Per-tile scene specialization (compile_scene_split) must not change
    the image: far-only tiles trace the exact far scene and near rays are
    conservatively classified (interpret mode)."""
    scene = reference_render_scene()
    csdf = compile_scene_csdf(scene)
    bb = scene_bounds(scene)
    split = compile_scene_split(scene)
    assert split is not None
    o, d, c = _rays(w=128, h=48)
    a = np.asarray(render_image_triton(csdf, o, d, c, bb=bb, interpret=True))
    b = np.asarray(
        render_image_triton(csdf, o, d, c, bb=bb, split=split, interpret=True)
    )
    diff = np.abs(a - b).max(-1)
    # step-count paths may differ on boundary pixels; colors must agree
    assert (diff > 1e-3).mean() < 1e-3
    assert diff.mean() < 1e-5
