"""The benchmark of the PyTorch and CUDA port (``montecarlopathtracer_tpu_torch``)
on one NVIDIA H100: ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, driven by ``BENCHMARK.json`` and the data
files under this directory (``configs/``, ``traffic/``), with one driver a
kind of timed loop (``drivers/``), one reader a per-layer metric
(``metrics/``) and a plain reference (``reference/``) that decides
``correct``."""
