"""Profiling: jax.profiler traces + speed-of-light estimates.

The counterpart of the reference's nvtx/cuProfilerStart/clock64
instrumentation (SURVEY §5): capture an xplane trace viewable in
TensorBoard/XProf, and compute analytic rooflines against the published
peaks of the device the run is on.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/bsdmg_trace"):
    """Capture a jax.profiler trace around a code region."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


#: Published peaks per ``jax.Device.device_kind``: (float32 FLOP/s outside
#: the tensor cores, device-memory bytes/s). NVIDIA H100 SXM data sheet
#: (dense, at the 700 W power limit): 67 TFLOP/s fp32, 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def device_peaks(device_kind: str | None = None) -> tuple[float, float]:
    """``(flops_per_s, bytes_per_s)`` of ``device_kind`` (default: the first
    device). A kind missing from :data:`PEAKS` is an error, not a default."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


@dataclass
class Roofline:
    """Analytic speed-of-light estimate: max(compute time, memory time).

    ``rays`` x ``avg_steps`` x ``ops_per_eval`` models the required FLOPs;
    ``total_bytes`` the single-pass device-memory traffic the stage cannot
    avoid. The light speed is whichever wall the stage hits first, against
    the device's published peaks (:func:`device_peaks`).
    """

    rays: int
    avg_steps: float
    ops_per_eval: float
    flops_per_s: float
    bytes_per_s: float
    total_bytes: float = 0.0

    @property
    def total_ops(self) -> float:
        return self.rays * self.avg_steps * self.ops_per_eval

    @property
    def compute_seconds(self) -> float:
        return self.total_ops / self.flops_per_s

    @property
    def memory_seconds(self) -> float:
        return self.total_bytes / self.bytes_per_s

    @property
    def seconds(self) -> float:
        return max(self.compute_seconds, self.memory_seconds)

    @property
    def bound(self) -> str:
        return (
            "compute" if self.compute_seconds >= self.memory_seconds
            else "memory"
        )

    def efficiency(self, measured_seconds: float) -> float:
        return self.seconds / measured_seconds


def render_roofline(width: int, height: int, avg_steps: float,
                    ops_per_eval: int = 110,
                    device_kind: str | None = None) -> Roofline:
    """Speed-of-light for the reference-scene render.

    ``ops_per_eval`` ~110: two factorized 12-edge skeletons (~40 ops each
    with cross-product grouping), sphere + smooth-min + march bookkeeping.
    ``avg_steps`` should come from the kernel's own measured steps plane
    (``bench.render_step_stats`` — use ``mean_tile_max_steps``, since the
    tile-synchronized march executes the per-tile max, not the per-ray
    mean); ``bench --which render --roofline`` prints the comparison.
    """
    return Roofline(width * height, avg_steps, ops_per_eval,
                    *device_peaks(device_kind))


def csdf_flops_per_eval(csdf) -> float:
    """Per-lane FLOPs of one baked component-SDF eval, from XLA's own
    cost analysis (compile a (8, 128) block, divide by 1024 lanes).

    Grounds every roofline's ``ops_per_eval`` in the compiler's count
    instead of a hand-maintained constant. A backend that reports no FLOP
    count is an error.
    """
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((8, 128), jnp.float32)
    ca = jax.jit(csdf).lower(x, x, x).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    if flops <= 0:
        raise ValueError("the compiler reported no FLOP count for the csdf")
    return flops / x.size


#: Single-pass HBM bytes per refined parent (the documented floor model):
#: 27 lattice coordinate planes + values (27 x 4 x 4B = 432), 8 children x
#: 3 coordinate planes written then block-gathered (2 x 96), one
#: single-pass fine sort over ~2 rows/parent x 4 columns read+write (64),
#: and the 3-column output stack (24). The production ``lax.sort`` is a
#: multi-pass sorting network, so the measured stage runs well above this
#: floor by construction — the % quantifies exactly that gap.
REFINE_BYTES_PER_PARENT = 712.0


def refine_roofline(
    parents: int,
    ops_per_eval: float = 55.0,
    bytes_per_parent: float = REFINE_BYTES_PER_PARENT,
    device_kind: str | None = None,
) -> Roofline:
    """Speed-of-light for one voxel-refinement level.

    The refine lattice evaluates the parent's shared 3x3x3 corner grid —
    **27 SDF evals per parent** (vs the reference's 64 independent child
    corners, compute_mesh_generation.cu:36-49); the 8-child sign test and
    border mask are a handful of compares folded into the rounding. The
    on-device blocked compaction (child planes, block gather, fine sort —
    see :data:`REFINE_BYTES_PER_PARENT`) adds the memory traffic; the
    multi-pass ``lax.sort`` network moves the fine-sort columns O(log^2 n)
    times against the floor model's single pass. The % of roofline
    quantifies the whole stage against that single-pass light speed.
    """
    return Roofline(
        parents, 27.0, ops_per_eval, *device_peaks(device_kind),
        total_bytes=parents * bytes_per_parent,
    )
