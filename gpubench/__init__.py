"""gpubench: the benchmark of avtex_torch on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a model configuration
under a traffic mix) once::

    python -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``gpubench/configs/<config>.json``, its traffic in
``gpubench/traffic/<traffic>.json`` (whose ``driver`` names the loop in
``gpubench/drivers/<driver>.py``), each per-layer metric's reader in
``gpubench/metrics/<metric>.py`` and the limits of its correctness check
in ``gpubench/limits/<workload>.json``. The plain fp32 reference that
decides ``correct`` is in ``gpubench/reference/``; operation and byte
counts and the chip's peaks are frozen in ``gpubench/flops.py``.

Nothing here imports ``jax`` or the JAX package ``avtex``.
"""
