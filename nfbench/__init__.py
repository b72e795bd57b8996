"""The benchmark of ``noahgameframe_tpu_torch`` on one NVIDIA H100.

``python -m nfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (see :mod:`nfbench.run`).  Data,
not code, makes a cell: ``configs/<config>.json`` (the deployment),
``traffic/<mix>.json`` (the entry and the loop) and ``metrics/<metric>.py``
(one reader per metric).  The plain reference that decides ``correct`` is
in ``reference/``; ``control.py`` runs its control.
"""
