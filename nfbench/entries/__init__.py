"""Entries, one module an entry: a traffic mix's ``entry`` with each ``.``
written ``_`` (see :mod:`nfbench.program`)."""
