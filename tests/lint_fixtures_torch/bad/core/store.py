"""Bad fixture for migrate-covers-store: ClassState grew a `shadow`
bank that persist/rowblob.py's ROW_LEAF_SPEC never learned about, so
cross-shard migration would leave it behind."""


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
    shadow: "Array"  # <- new bank, not in the spec
    timers: "TimerState"
    records: "Dict[str, RecordState]"


class WorldState:
    classes: "Dict[str, ClassState]"
    tick: "Array"
    rng: "Array"
    aux: "Dict[str, Any]"
    era: "Array"  # <- new world leaf, not in the room pack spec
