"""Clean drill runner: monotonic()/sleep() pacing only."""
import time


def pace(interval_s: float) -> None:
    deadline = time.monotonic() + interval_s
    while time.monotonic() < deadline:
        time.sleep(0.01)
