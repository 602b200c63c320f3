"""Roofline / speed-of-light estimates (utils/profiling.py).

The BASELINE north star is "profiled vs speed-of-light per chip" for every
kernel; these tests pin the analytic models' structure so the published
percentages can't silently drift: the FLOP count comes from XLA's own cost
analysis, the peaks from a table keyed by the device kind (an unknown
device is an error), and each stage's bound (compute vs memory) is asserted
by name.
"""

import pytest

from bsdmg_tpu.utils.profiling import (
    PEAKS,
    Roofline,
    csdf_flops_per_eval,
    device_peaks,
    refine_roofline,
    render_roofline,
)

H100 = "NVIDIA H100 80GB HBM3"


class TestRoofline:
    def test_seconds_is_max_of_compute_and_memory(self):
        r = Roofline(1000, 10.0, 100.0, *PEAKS[H100], total_bytes=0.0)
        assert r.seconds == r.compute_seconds
        assert r.bound == "compute"
        heavy = Roofline(1000, 10.0, 100.0, *PEAKS[H100], total_bytes=1e12)
        assert heavy.seconds == heavy.memory_seconds
        assert heavy.bound == "memory"

    def test_efficiency_inverse_in_measured_time(self):
        r = render_roofline(1920, 1080, avg_steps=50.0, device_kind=H100)
        assert r.efficiency(2 * r.seconds) == pytest.approx(0.5)

    def test_h100_peaks_from_data_sheet(self):
        # NVIDIA H100 SXM data sheet: 67 TFLOP/s fp32, 3.35 TB/s
        assert device_peaks(H100) == (67e12, 3.35e12)
        r = render_roofline(1000, 1, avg_steps=1.0, ops_per_eval=67,
                            device_kind=H100)
        assert r.compute_seconds == pytest.approx(1e-9)


class TestCsdfFlops:
    def test_xla_cost_analysis_per_lane(self):
        from bsdmg_tpu.models import reference_object, reference_render_scene
        from bsdmg_tpu.ops.pallas import compile_scene_csdf

        obj = csdf_flops_per_eval(compile_scene_csdf(reference_object()))
        # one factorized 12-edge skeleton + sphere + smooth-min
        assert 30 <= obj <= 120
        ren = csdf_flops_per_eval(
            compile_scene_csdf(reference_render_scene())
        )
        # the render scene adds the frame skeleton: strictly more work
        assert ren > obj

    def test_uncompilable_is_an_error(self):
        with pytest.raises(TypeError):
            csdf_flops_per_eval(object())

    def test_unknown_device_kind_is_an_error(self):
        import jax

        # the CPU test platform has no published peak: no silent default
        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks()
        with pytest.raises(ValueError):
            render_roofline(64, 64, avg_steps=1.0,
                            device_kind=jax.devices()[0].device_kind)


class TestStageRooflines:
    def test_refine_is_memory_bound(self):
        # the blocked-compaction traffic hits the memory wall before the
        # 27-evals-per-parent lattice hits the compute wall
        r = refine_roofline(262144, ops_per_eval=55.0, device_kind=H100)
        assert r.bound == "memory"
        assert r.total_ops == 262144 * 27 * 55.0

    def test_render_step_stats_tiles(self):
        """The roofline's step count comes from the march itself, reduced
        over the render kernel's pixel tiles: the per-tile max bounds the
        per-ray mean from above and the frame max from below."""
        from bsdmg_tpu.bench import render_step_stats

        s = render_step_stats(64, 32)
        assert 0 < s["mean_steps"] <= s["mean_tile_max_steps"] <= s["max_steps"]
        assert s["max_steps"] <= 256
