"""RetryPolicy: capped exponential backoff with deterministic jitter.

The reference reconnects on a fixed 10 s timer
(`NFINetClientModule.hpp:312-370`, `RECONNECT_SECONDS`).  A fixed timer
is both too slow for a healthy peer that bounced (always waits the full
period) and too aggressive for a dead one (every client in the cluster
re-dials in lockstep, a thundering herd on recovery).  The policy keeps
the old constant as the *base* delay — existing configs read unchanged —
and grows it exponentially per consecutive failure up to a cap, with a
deterministic per-(key, attempt) jitter so concurrent dialers de-sync
without making tests flaky: the same seed/key/attempt always yields the
same delay.

A copy of ``noahgameframe_tpu/net/retry.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import zlib

from .defines import RECONNECT_CAP_SECONDS, RECONNECT_SECONDS


class RetryPolicy:
    """``delay(attempt)`` = min(cap, base * factor^(attempt-1)) ± jitter.

    `attempt` counts consecutive failures (1 = first retry).  Jitter is
    a multiplicative ±`jitter` fraction derived from crc32(seed, key,
    attempt) — reproducible, no shared RNG state, distinct per link.
    """

    def __init__(self, base: float = RECONNECT_SECONDS,
                 cap: float = RECONNECT_CAP_SECONDS,
                 factor: float = 2.0, jitter: float = 0.25,
                 seed: int = 0) -> None:
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def delay(self, attempt: int, key: object = 0) -> float:
        d = min(self.cap, self.base * self.factor ** max(0, int(attempt) - 1))
        if self.jitter:
            h = zlib.crc32(f"{self.seed}:{key}:{int(attempt)}".encode())
            u = h / 0xFFFFFFFF  # uniform [0, 1], deterministic
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return min(d, self.cap)
