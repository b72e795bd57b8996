"""``kernel.run_device``: one replay of the captured tick
(``run_device(1, reconcile=False)``), ended by a device sync; deaths are
reconciled after the window.  The tick spine, with no host observation."""

import torch

KINDS = ("world",)
BOOK = "kernel.run"


def prepare(dep) -> None:
    pass


def frame(dep) -> None:
    dep.kernel.run_device(1, reconcile=False)
    if dep.device.type == "cuda":
        torch.cuda.synchronize(dep.device)
