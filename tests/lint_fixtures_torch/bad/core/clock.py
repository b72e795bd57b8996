"""wall-clock + unseeded-rng violations, one per offense class."""
import random
import time
from time import time as now

import numpy as np


def stamp():
    return time.time()  # direct wall clock


def stamp_aliased():
    return now()  # from-import alias wall clock


def shuffle(items):
    random.shuffle(items)  # process-global RNG
    return items


def unseeded_instance():
    return random.Random()  # unseeded instance = global-ish


def noise(n):
    rng = np.random.default_rng()  # seedless generator
    return rng.normal(size=n)


def torch_noise(n):
    import torch

    torch.manual_seed(0)  # reseeds the process-global generator
    return torch.randn(n)  # draw without generator=
