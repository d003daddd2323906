"""rtbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python3 rtbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything a
cell needs is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/mixes/``, each per-layer metric's reader in
``metrics/`` and each kernel's operation and byte counts in ``costs/``.
Nothing here imports JAX or the JAX package.
"""
