"""Monte Carlo path tracer on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of :mod:`montecarlopathtracer_tpu`. Module names mirror
the JAX package, so the counterpart of ``montecarlopathtracer_tpu.X`` is
``montecarlopathtracer_tpu_torch.X``, and public functions keep its data
contracts (ray state ``f32[3, R]``, masks ``[R]``, the 48-float winner
row layout, ``idx = -1`` for a miss), so arrays convert 1:1 through
numpy (:mod:`.convert`).

Plain tensor code is PyTorch; the kernels of the render, regen,
large-scene, split and gradient paths (the whole path segment, with
scalar or per-lane flags and with or without chunk culling, the segment
from known winners and the segment's vjp, ``ops/segment_fused.py``; the
row-cotangent scatter, ``ops/scatter_rows.py``; the Morton-chunk
traversal walk, ``ops/traverse_walk.py``; the split path's nearest hit
and the fused intersector's index, ``ops/nearest_shade.py``) are
hand-written CUDA for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at
first use.
Every kernel has a plain-torch version beside it that runs for CPU
tensors.

Importing the package imports nothing heavy; import the submodules.
"""

from .version import __version__

__all__ = ["__version__"]
