"""The port's benchmark: one cell of ``BENCHMARK.json`` per process.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON result line. Every
part of a cell is found by name: its configuration under ``configs/``,
its traffic mix under ``traffic/``, the driver of the mix's kind under
``drivers/``, its correctness limits under ``limits/`` and each per-layer
metric's reader under ``metrics/``. A cell that cannot be measured yet
waits whole under ``pending/`` (see ``harness.load_bench``). The yardstick (peaks, operation and
byte counts, the trace reduction, the arrival generator, the comparisons)
lives under ``yardstick/`` and the plain reference under ``reference/``.
"""
