"""drill-clockless violation: a wall/runtime clock in a tick schedule."""
import time


def next_fault_tick(base_tick: int) -> int:
    # a runtime clock inside what is declaratively a tick schedule
    return base_tick + int(time.monotonic())
