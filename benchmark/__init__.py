"""The benchmark of the PyTorch port (``cst_captioning_tpu_torch``) on one
NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line. Everything a cell needs is found by name:
``configs/<config>.json`` (the model), ``traffic/<traffic>.json`` (the
mix's parameters), ``kinds/<kind>.py`` (the driver, the reference's
verdict, the control and the faults of the kind that a traffic file
names), ``workloads/<cell>.json`` (the cell's batch, threads, limits and
``why``) and ``metrics/<metric>.py`` (one reader a per-layer metric).
The plain reference that decides ``correct`` is ``reference/``;
``control.py`` reads the limits' evidence on the chip.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
(``guard.py`` checks ``sys.modules`` by whole top-level name).
"""
