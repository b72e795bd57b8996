"""Clean drill schedule: pure tick arithmetic, no time module at all."""


def next_fault_tick(base_tick: int, period_ticks: int) -> int:
    return base_tick + period_ticks
