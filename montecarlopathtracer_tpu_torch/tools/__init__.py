"""Command-line tools of the port, the twins of the JAX package's
``tools/``: run each with ``python -m montecarlopathtracer_tpu_torch.tools.<name>``.

- :mod:`.kernel_bench`: the selection entries B8-B10 timed on the Cornell
  box and the bunny (``tools/kernel_bench.py``);
- :mod:`.kernel_micro`: the selection-step microkernels B12-B14 timed
  (``tools/kernel_micro.py``).

The intersector gate of ``tools/tpu_check.py`` is part of
``chip_smoke.py``.
"""
