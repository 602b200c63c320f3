"""bsdmg_tpu — differentiable signed-distance renderer + mesh generator.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
``Meterius/bevy-signed-distance-mesh-generation`` (Rust/Bevy/CUDA):

* sphere-traced ray-marching renderer of analytic CSG SDF scenes with per-pixel
  cone-radius adaptive collision thresholds, finite-difference normals,
  two-color Lambert shading and an ACES tonemap
  (reference: cuda/modules/compute_render.cu),
* hierarchical SDF voxel-field refinement + marching-cubes surface extraction
  with Newton projection of vertices onto the isosurface
  (reference: cuda/modules/compute_mesh_generation.cu),

built from batched functional transforms, static shapes with mask-and-compact
instead of CPU stream compaction, a Pallas (Triton) render kernel for the GPU,
and `jax.sharding` meshes for multi-device scaling.
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache. JAX_COMPILATION_CACHE_DIR, when set, is
# read by JAX itself and nothing is set here; otherwise the cache lives at a
# fixed path inside the checkout (the path is part of the cache key, so it
# must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

from bsdmg_tpu import config
from bsdmg_tpu.config import (
    MarchConfig,
    MeshGenConfig,
    RenderConfig,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "MarchConfig",
    "MeshGenConfig",
    "RenderConfig",
    "__version__",
]
