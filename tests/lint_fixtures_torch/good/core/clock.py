"""Clean counterpart: injectable-now patterns and seeded RNGs."""
import random
import time

import numpy as np


def stamp():
    return time.monotonic()  # injectable-now pattern, not wall time


def shuffle(items, seed: int):
    random.Random(seed).shuffle(items)  # seeded instance
    return items


def noise(n, seed: int):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n)


def annotate(rng: np.random.Generator):
    """Attribute load in an annotation, not a call — must pass."""
    return rng


def torch_noise(n, seed: int):
    import torch

    gen = torch.Generator().manual_seed(seed)  # an explicit generator
    return torch.randn(n, generator=gen)
