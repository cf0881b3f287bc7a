"""The benchmark of the PyTorch/CUDA port (``ladine_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``);
``portbench.sweep`` finds the open cell's rate, ``portbench.control``
reads the judge's numbers on the program and on its control. Nothing here
imports JAX or the JAX package, and ``reference/`` imports nothing of the
port.
"""
