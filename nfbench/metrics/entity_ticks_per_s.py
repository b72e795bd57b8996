"""Entities in the world times frames completed, over the window's seconds."""

from nfbench.stats import rate


def read(run):
    return rate(run["entities"], run["frames"], run["window_s"])
