"""Bad fixture for migrate-covers-store: the spec misses the store's
`shadow` bank AND still names a `ghost` field the store no longer has."""

ROW_LEAF_SPEC = (
    "i32",
    "f32",
    "vec",
    "alive",
    "ghost",  # <- stale: no such ClassState field
    "timers.next_fire",
    "timers.interval",
    "timers.remain",
    "timers.active",
    "records.*.i32",
    "records.*.f32",
    "records.*.vec",
    "records.*.used",
)

MIGRATION_EXCLUDED = ()
