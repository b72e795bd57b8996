"""The whole tick against the HBM roof: the least bytes a frame must move
(every state column the tick's phases read or write, read once and
written once, for each occupied row; an empty row's alive byte; counts
frozen in the configuration file) at the card's bandwidth, over the
frame's device time (busy seconds of the traced frames over their
count)."""

from nfbench.roofline import HBM_BYTES_PER_S, step_bytes


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0 or not tr["frames"]:
        return None
    cfg = run["config"]
    least = step_bytes(cfg["rows"], cfg["occupied_rows"], cfg["step_bytes_per_row"],
                       cfg["step_bytes_empty_row"])
    return 100.0 * least / HBM_BYTES_PER_S / (tr["busy_s"] / tr["frames"])
