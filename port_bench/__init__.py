"""Benchmark of the PyTorch/CUDA package ``music_generation_tpu_torch``.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric lives in a file of its own that the harness finds by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model sizes as run, their source, what
  was cut and assumed, the precision;
- ``traffic/<traffic>.json``: the mix's parameters, read by the driver
  the file names (``drivers/<driver>.py``);
- ``metrics/<metric>.py``: a reader of one per-layer metric.

``reference/`` is the plain reference the outputs are compared with,
``counts/`` the operations and bytes behind every utilisation and
roofline share, ``harness/`` the shared machinery.
"""
