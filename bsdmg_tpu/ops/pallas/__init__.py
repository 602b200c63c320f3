"""Component-form scenes and the GPU render kernel.

* ``csdf`` — component-form (x, y, z planes) scene SDFs with parameters
  baked as Python constants, plus the scene bounds and near/far split the
  render kernel's culling uses.
* ``render_triton`` — the fused per-tile sphere tracer + shade, a Pallas
  kernel through Triton (one program per 8x16 pixel tile, the reference's
  128-thread block, cuda/modules/compute_render.cu:21-97).
"""

from bsdmg_tpu.ops.pallas.csdf import compile_scene_csdf

__all__ = ["compile_scene_csdf"]
