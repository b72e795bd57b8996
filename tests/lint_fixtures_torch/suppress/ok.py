"""Used suppressions: same-line and wrapped standalone forms."""
import time

BOOT_STAMP = time.time()  # nf-lint: disable=wall-clock -- reviewed boot stamp

# nf-lint: disable=wall-clock -- wrapped reason: this live stamp is
# operator-facing telemetry, never journaled, so replay cannot see it
LIVE_STAMP = time.time()
