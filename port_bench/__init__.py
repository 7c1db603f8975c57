"""The benchmark of libdeflate_tpu_torch, the PyTorch and CUDA port.

``python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``);
``README.md`` says how to add a cell or a metric.  Nothing here imports
JAX or the JAX package ``libdeflate_tpu``.
"""
