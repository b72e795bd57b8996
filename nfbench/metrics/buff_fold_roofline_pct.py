"""The buff fold kernel against its roofline: the least time of the
fold's launches of one frame (each row's buff list read once, its stat
contributions and used flags written once, at the card's bandwidth;
:mod:`nfbench.roofline_buffs`) over the device time ``buff_fold_kernel``
took per traced frame.  None where no such kernel ran."""

from nfbench.roofline_buffs import buff_fold_bound_s

KERNEL = "buff_fold_kernel"


def read(run):
    tr = run["trace"]
    if tr is None or not tr["frames"]:
        return None
    spent = sum(s for name, s in tr["device_s"].items() if KERNEL in name)
    if spent <= 0:
        return None
    cfg = run["config"]
    bound = buff_fold_bound_s(cfg["rows"], cfg["buff_fold_bytes_per_row"])
    return 100.0 * bound / (spent / tr["frames"])
