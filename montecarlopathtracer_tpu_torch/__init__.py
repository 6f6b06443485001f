"""Monte Carlo path tracer on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of :mod:`montecarlopathtracer_tpu`. Module names mirror
the JAX package, so the counterpart of ``montecarlopathtracer_tpu.X`` is
``montecarlopathtracer_tpu_torch.X``, and public functions keep its data
contracts (ray state ``f32[3, R]``, masks ``[R]``, the 48-float winner
row layout, ``idx = -1`` for a miss), so arrays convert 1:1 through
numpy (:mod:`.convert`).

Plain tensor code is PyTorch; the one kernel on the forward render path
(the whole path segment, ``ops/segment_fused.py``) is hand-written CUDA
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use. Every
kernel has a plain-torch version beside it that runs for CPU tensors.

Importing the package imports nothing heavy; import the submodules.
"""

from .version import __version__

__all__ = ["__version__"]
