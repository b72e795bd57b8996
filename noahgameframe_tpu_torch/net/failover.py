"""Session failover's refusal codes, which the game role's switch-in
handler answers with (``SwitchRefused.result``; 0 is never sent).

Counterpart of the constants in ``noahgameframe_tpu/net/failover.py``; the
failover supervisor itself comes with the cluster roles.
"""

from __future__ import annotations

REFUSE_BUSY = 1      # target at Player capacity: try another survivor
REFUSE_BAD_BLOB = 2  # staged blob failed to apply (torn in transit)
