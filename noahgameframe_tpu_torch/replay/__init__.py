"""Deterministic flight recorder, the parts that need no game role.

- :mod:`journal`: the append-only, segmented, CRC-framed tick journal in
  the JAX package's byte format (a journal written by either package
  reads back in the other);
- :mod:`bisect`: the first divergent tick between two digest streams, and
  a field-level diff of two world states.

Replaying a journal through a game role (``replay_journal``) comes with
the serving edge.
"""

from .journal import (  # noqa: F401
    JournalError,
    JournalReader,
    JournalWriter,
    REC_CKPT,
    REC_EVENT,
    REC_META,
    REC_NOTE,
    REC_TICK,
    SRC_SERVER,
    SRC_WORLD,
    read_ticks,
)
from .bisect import bisect_divergence, field_diff, first_divergence_linear  # noqa: F401
