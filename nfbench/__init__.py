"""The benchmark of ``noahgameframe_tpu_torch`` on one NVIDIA H100.

``python -m nfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (see :mod:`nfbench.run`).  A cell
is found by name, file by file: ``configs/<config>.json`` (the deployment,
whose ``kind`` names ``deployments/<kind>.py`` and ``checks/<kind>.py``),
``traffic/<mix>.json`` (the loop, whose ``entry`` names
``entries/<entry>.py``) and ``metrics/<metric>.py`` (one reader per
metric).  The plain reference that decides ``correct`` is in
``reference/``; ``control.py`` runs the check's control.
"""
