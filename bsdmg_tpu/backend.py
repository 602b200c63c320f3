"""The one place that chooses an implementation by platform."""

from __future__ import annotations

import jax


def use_render_kernel() -> bool:
    """Render param-baked scenes with the Triton tile kernel
    (``ops/pallas/render_triton.py``)? True on a GPU, where it beats the XLA
    march (``ops.shade.render_image_c``) end to end; elsewhere the XLA march
    serves."""
    return jax.default_backend() == "gpu"
