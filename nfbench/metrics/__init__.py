"""One reader per metric, ``<metric>.py`` with ``read(run)``: the metric's
value from the run, or None where the run holds nothing to read.

``run`` holds ``entities``, ``frames``, ``window_s``, ``frame_s`` (each
frame's seconds), ``setup_s``, ``launches`` (the cost book's launches per
replay of the entry's ``BOOK``), ``trace`` (None, or the reduced device
trace of :mod:`nfbench.trace`), ``config``, ``traffic``, and what the
kind's check adds through ``readings`` (a world's: ``pairs_per_frame``,
occupied fold pairs, from the reference's binning of the late checked
frame).
"""
