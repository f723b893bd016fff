"""The benchmark of the PyTorch and CUDA port (``gpuaudiobench_tpu_torch``).

``python -m rtbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel cost or reference lives in a file of its own
under this folder, found by the name ``BENCHMARK.json`` gives it.
"""
