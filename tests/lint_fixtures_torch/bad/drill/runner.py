"""drill runner clock violation: wall time beyond monotonic/sleep."""
import time


def pace(interval_s: float) -> float:
    return time.time() + interval_s  # wall clock, not pacing
