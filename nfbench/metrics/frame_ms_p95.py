"""The 95th percentile of every frame of the window, in milliseconds."""

from nfbench.stats import percentile


def read(run):
    return percentile(run["frame_s"], 95.0) * 1e3
