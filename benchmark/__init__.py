"""The benchmark of ``bolt_tpu_torch`` on one NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Every piece is found by its name: ``configs/<config>.json``
(the dataset), ``traffic/<mix>.json`` (the pass, as branches of steps),
``ops/<step>.py`` (how the program runs a step and what it declares),
``reference/<step>.py`` (the plain PyTorch reference of a step and its
comparison), ``metrics/<metric>.py`` (one per-layer metric) and
``limits/<cell>.json`` (the limits of the comparison).  Nothing here
imports ``jax`` or the JAX package; ``reference/`` imports nothing of
``bolt_tpu_torch`` either.
"""
