"""Deployment kinds, one module a kind: ``<kind>.py`` for a configuration
whose ``kind`` is ``<kind>`` (see :mod:`nfbench.program`)."""
