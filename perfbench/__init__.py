"""The benchmark of ``repro_torch``, the PyTorch and CUDA serving system.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell is made of is a file found by its
name: ``configs/<config>.json`` (the model's sizes as run, with its
source), ``traffic/<traffic>.json`` (the traffic mix, the engine settings
and the limits of the comparison that decides ``correct``) and
``metrics/<metric>.py`` (one reader per metric). The yardstick lives here
too: the traffic generator (``traffic.py``), the peaks and the operation
and byte counts of the kernels and the model (``roofline.py``), the
reading of the profiler's trace (``trace.py``), the plain reference
(``reference/``) and the comparison (``check.py``). Nothing here imports
``jax`` or the JAX package ``repro``.
"""
