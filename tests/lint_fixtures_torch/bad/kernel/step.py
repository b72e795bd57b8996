"""capture-safety violations: every host-sync class, reached through one
call-graph hop from a graph-captured cost-book entry."""
import os

import torch


def _helper(state):
    torch.cuda.synchronize()  # host sync
    print("tick", state)  # host I/O in the captured path
    level = os.environ.get("NF_LEVEL", "")  # capture-time config read
    hp = float(state)  # concretizes a tensor
    raw = state.item()  # device->host copy
    host = state.cpu()  # device->host copy
    arr = state.numpy()  # device->host copy
    rows = torch.nonzero(state)  # data-dependent size
    alive = state > 0
    picked = state[alive]  # boolean-mask indexing
    return state, level, hp, raw, host, arr, rows, picked


def _tick(state):
    return _helper(state)


class Engine:
    def __init__(self, costbook):
        self.costbook = costbook
        self.step = costbook.wrap("tick", _tick, graph=True)
