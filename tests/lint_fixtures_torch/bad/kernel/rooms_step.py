"""capture-safety violation under vmap: a bit view in a helper that the
vmapped rooms step reaches (the card's torch has no batching rule)."""
import torch


def _bits(x):
    return x.view(torch.int32)


def room_step(leaves):
    return _bits(leaves)


def run_rooms(leaves):
    return torch.func.vmap(room_step)(leaves)
