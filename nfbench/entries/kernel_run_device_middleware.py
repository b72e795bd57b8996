"""``kernel.run_device`` on the game role's own world: one replay of the
captured tick (``run_device(1, reconcile=False)``), ended by a device
sync; deaths are reconciled after the window.  The same entry point, cost
book entry and frame as :mod:`nfbench.entries.kernel_run_device`, for
the ``world_middleware`` kind."""

from nfbench.entries.kernel_run_device import BOOK, frame, prepare

KINDS = ("world_middleware",)

__all__ = ["KINDS", "BOOK", "prepare", "frame"]
