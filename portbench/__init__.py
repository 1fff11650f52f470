"""The port's benchmark: one command runs one cell of ``BENCHMARK.json``.

Run from the repository root::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Configurations (``configs/``), cells (``workloads/``), request kinds
(``requests/``), the port's instances (``programs/``), the plain reference
models (``reference/models/``) and the metric readers (``metrics/``) are
files found by the names ``BENCHMARK.json`` gives.
"""
