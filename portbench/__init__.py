"""The benchmark of ``alayalite_tpu_torch`` on one CUDA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Nothing here imports ``jax`` or the JAX package, and the reference
(``reference.py``) imports nothing of the program.
"""
