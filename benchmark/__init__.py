"""The benchmark of ``rtow_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Every
configuration, traffic mix, end-to-end metric and per-layer metric is a
file of its own here, found by its name: ``configs/<name>.json``,
``traffic/<name>.json``, ``end_to_end/<name>.py``, ``metrics/<name>.py``,
with the driver of each traffic kind in ``drivers/<kind>.py``, the scene
of each configuration in ``scenes/<scene>.py`` and the limits of each
cell's output check in ``limits/<cell>.json``.  ``reference/`` is the
plain PyTorch path tracer the outputs are held to; it imports nothing of
the program.
"""
