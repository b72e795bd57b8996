"""The combat fold kernel against its roofline: the least time of one
fold over the grid (inputs read once, int32 outputs written once, five
float32 operations per occupied pair) over the device time that the
fold's kernels took per traced frame."""

from nfbench.roofline import fold_bound_s

KERNELS = ("combat_fold_kernel", "combat_fold_chunk_kernel")


def read(run):
    tr = run["trace"]
    if tr is None or not tr["frames"]:
        return None
    spent = sum(s for name, s in tr["device_s"].items() if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    geo = run["config"]["geometry"]
    bound = fold_bound_s(int(geo["width"]) ** 2, int(geo["kv"]), int(geo["ka"]),
                         run["pairs_per_frame"])
    return 100.0 * bound / (spent / tr["frames"])
