"""The benchmark of the PyTorch/CUDA port ``ecwam_tpu_torch`` on one card.

``python3 -m wavebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root runs one cell of
``BENCHMARK.json``: set-up, a measured window of whole forecast hours,
then the check against the plain reference in :mod:`wavebench.reference`,
and prints one JSON line.  Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``
and, for each per-layer metric, ``metrics/<metric>.py``.
"""
