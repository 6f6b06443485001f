"""Command-line tools of the port, the twins of the JAX package's
``tools/``: run each with ``python -m montecarlopathtracer_tpu_torch.tools.<name>``.

- :mod:`.kernel_bench`: the selection entries B8-B10 timed on the Cornell
  box and the bunny (``tools/kernel_bench.py``);
- :mod:`.kernel_micro`: the selection-step microkernels B12-B14 timed
  (``tools/kernel_micro.py``);
- :mod:`.scaling_bench`: the sharded pass timed over worlds of 1, 2, 4
  and 8 ranks (``tools/scaling_bench.py``; it writes
  ``out/scaling_torch.json``, never ``SCALING.json``);
- :mod:`.bench_suite`: the scene × intersector sweep
  (``tools/bench_suite.py``; it writes ``out/bench_scenes_torch.json``,
  never ``BENCH_SCENES.json``);
- :mod:`.golden_run`: the reference's golden workloads against its PNGs
  (``tools/golden_run.py``; it writes ``out/goldens_torch/``, never
  ``goldens/``);
- :mod:`.wseg_check`: the whole segment against the split path
  (``tools/wseg_check.py``; ``chip_smoke.py`` phases 28-29 run its check).

The intersector gate of ``tools/tpu_check.py`` is part of
``chip_smoke.py``.
"""
