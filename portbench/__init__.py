"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card: a model
configuration (``configs/``) under a traffic mix (``traffic/``), its
metrics read by one reader a metric (``metrics/``), its output held
against the plain reference (``reference/``) within the cell's limits
(``limits/``). Nothing here imports JAX or the JAX package, and the
reference imports nothing of the program.
"""
