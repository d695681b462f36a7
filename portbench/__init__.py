"""The benchmark of ``junctiontree_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``core``.  Nothing
here imports JAX or the JAX package, and the reference (``reference``)
imports nothing of the program.
"""
