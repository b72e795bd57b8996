"""Clean captured shapes: sizes come from .shape, nothing is read back."""
import torch


def _tick(xs):
    idx = torch.arange(xs.shape[0])
    return idx, torch.zeros(xs.shape[1:])


class Runner:
    def __init__(self, costbook):
        self.step = costbook.wrap("tick", _tick, graph=True)
