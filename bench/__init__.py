"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``bench/configs/``, its traffic mix in ``bench/traffic/``, its correctness
limits in ``bench/limits/`` and each per-layer metric's reader in
``bench/metrics/``. See ``bench/README.md``.
"""
