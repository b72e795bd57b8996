"""Deterministic flight recorder.

- :mod:`journal`: the append-only, segmented, CRC-framed tick journal in
  the JAX package's byte format (a journal written by either package
  reads back in the other);
- :mod:`replayer`: an offline game role re-executes a journal through its
  dispatch tables and tick and checks every per-tick digest
  (``replay_journal``, ``make_offline_role``);
- :mod:`bisect`: the first divergent tick between two digest streams, a
  field-level diff of two world states, ``dump_divergence`` over two
  journals, and the ``python -m noahgameframe_tpu_torch.replay.bisect``
  command line.

The replayer imports the game role, so it is imported by path, not here.
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
