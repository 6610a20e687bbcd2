"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` measures one cell of ``BENCHMARK.json``; see
``perfbench/README.md``.  Nothing here imports JAX or the JAX package.
"""
