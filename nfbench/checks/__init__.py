"""Correctness checks, one module a deployment kind: ``<kind>.py`` judges
every cell whose configuration has that ``kind`` (see :mod:`nfbench.run`)."""
