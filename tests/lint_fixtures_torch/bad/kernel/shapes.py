"""recapture-hazard violations: shapes taken from host reads inside a
captured step."""
import torch


def _tick(xs):
    idx = torch.arange(len(xs))  # every distinct length is a fresh capture
    out = torch.zeros(xs.sum(0).tolist())  # a host read sizes the capture
    return idx, out


class Runner:
    def __init__(self, costbook):
        self.step = costbook.wrap("tick", _tick, graph=True)
