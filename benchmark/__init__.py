"""The benchmark of the PyTorch and CUDA port (``nydus_snapshotter_tpu_torch``).

One command runs one cell once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells. Everything a cell
needs is found by name: its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json`` (read by the generator module the file
names), the program driver the configuration names in ``drivers/``, each
per-layer metric's reader in ``metrics/<metric>.py``, and the plain reference
of the configuration's digester and compressor in ``reference/``. A later
cell, configuration or metric adds files; it edits none.

Nothing here imports ``jax`` or the JAX package; the reference imports
nothing of the port.
"""
