"""CLI unit tests that need no device work: argument and spec parsing."""

from bsdmg_tpu.cli import _parse_mesh_spec, build_parser


class TestMeshSpecParsing:
    def test_plain_path(self):
        assert _parse_mesh_spec("model.obj") == ("model.obj", 128)

    def test_path_with_resolution(self):
        assert _parse_mesh_spec("model.obj:64") == ("model.obj", 64)

    def test_path_containing_colon_keeps_path(self):
        # a colon inside the path must not be eaten as a resolution
        assert _parse_mesh_spec("runs:v2/model.obj") == ("runs:v2/model.obj", 128)

    def test_trailing_colon_typo_keeps_path(self):
        assert _parse_mesh_spec("model.obj:") == ("model.obj:", 128)

    def test_colon_path_plus_resolution(self):
        assert _parse_mesh_spec("runs:v2/model.obj:32") == ("runs:v2/model.obj", 32)


class TestFitFlags:
    def test_perturb_parses(self):
        from bsdmg_tpu.cli import _parse_perturb

        assert _parse_perturb("n1_radius=1.25, n0_k=*0.6, n1_center=+0.5") == {
            "n1_radius": ("mul", 1.25),
            "n0_k": ("mul", 0.6),
            "n1_center": ("add", 0.5),
        }

    def test_apply_perturb_rejects_noop(self):
        import jax.numpy as jnp
        import pytest

        from bsdmg_tpu.cli import _apply_perturb

        params = {"c": jnp.zeros(3, jnp.float32), "r": jnp.float32(1.0)}
        with pytest.raises(SystemExit, match="unchanged"):
            _apply_perturb(params, {"c": ("mul", 1.3)})
        out = _apply_perturb(params, {"c": ("add", 0.5), "r": ("mul", 1.3)})
        assert float(out["r"]) == pytest.approx(1.3)
        assert float(out["c"][0]) == pytest.approx(0.5)

    def test_perturb_rejects_garbage(self):
        import pytest

        from bsdmg_tpu.cli import _parse_perturb

        with pytest.raises(SystemExit):
            _parse_perturb("n1_radius")
        with pytest.raises(SystemExit):
            _parse_perturb("")

    def test_fit_takes_scene(self):
        a = build_parser().parse_args(
            ["fit", "--scene", "x.json", "--perturb", "n1_radius=1.3"]
        )
        assert a.scene == "x.json"
        assert a.perturb == "n1_radius=1.3"


class TestBenchFlags:
    def test_roofline_and_trace(self):
        a = build_parser().parse_args(
            ["bench", "--which", "render", "--roofline", "--trace", "t"]
        )
        assert (a.which, a.roofline, a.trace) == ("render", True, "t")

    def test_defaults(self):
        a = build_parser().parse_args(["bench", "--which", "render"])
        assert (a.roofline, a.trace, a.width, a.height) == (False, None, 1920, 1080)


class TestChipSmoke:
    def test_exits_nonzero_without_gpu(self):
        """chip_smoke.py refuses to run without a GPU: a non-zero exit that
        names the missing GPU, and no JSON result line."""
        import os
        import subprocess
        import sys

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, os.path.join(root, "chip_smoke.py")],
            capture_output=True, text=True, env=env, timeout=300, cwd=root,
        )
        assert r.returncode != 0
        assert "no GPU found" in r.stderr + r.stdout
        assert '"ok"' not in r.stdout
