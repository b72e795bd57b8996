"""Good fixture for migrate-covers-store: every ClassState leaf is
enumerated by the rowblob spec, nothing stale."""


class TimerState:
    next_fire: "Array"
    interval: "Array"
    remain: "Array"
    active: "Array"


class RecordState:
    i32: "Array"
    f32: "Array"
    vec: "Array"
    used: "Array"


class ClassState:
    i32: "Array"
    f32: "Array"
    vec: "Array"
    alive: "Array"
    timers: "TimerState"
    records: "Dict[str, RecordState]"


class WorldState:
    classes: "Dict[str, ClassState]"
    tick: "Array"
    rng: "Array"
    aux: "Dict[str, Any]"
