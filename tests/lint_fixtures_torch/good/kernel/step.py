"""Clean captured step: the only host sync sits inside the sanctioned
stage-timing span, masks select with torch.where, and every int() reads
a host value (the refinements of what counts as tensor-rooted)."""
import enum
from typing import Optional, Sequence, Tuple

import torch


class Group(enum.IntEnum):
    BUFF = 3


def _helper(state, stage_timing: bool = False):
    if stage_timing:
        torch.cuda.synchronize()  # honest device timing, sanctioned
    alive = state > 0
    return torch.where(alive, state, 0)


def fold_in(key, data):
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64)
    else:  # int() in the isinstance-negative branch: a host value
        d = torch.full((1,), int(data), dtype=torch.int64)
    return key + d


def walk(pos, tick):
    t = tick.to(torch.int64) if isinstance(tick, torch.Tensor) else int(tick)
    return pos + t


def write_buff(i32, contrib):
    i32[:, int(Group.BUFF)] = contrib  # an enum member, not a tensor
    return i32


def ppermute(xs, perm: Sequence[Tuple[int, int]], n_cells: Optional[int] = None):
    src_of = {int(dst): int(src) for src, dst in perm}  # declared host ints
    return xs, src_of, n_cells


def _tick(state):
    base = torch.zeros(4)
    state = fold_in(state, 3)
    state = walk(state, 1)
    write_buff(state, base)
    ppermute(state, [(0, 1)])
    return _helper(state), base


class Engine:
    def __init__(self, costbook):
        self.costbook = costbook
        self.step = costbook.wrap("tick", _tick, graph=True)
