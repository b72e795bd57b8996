"""Good fixture for migrate-covers-store: the spec matches the store's
ClassState exactly; the exclusion list is empty by design."""

ROW_LEAF_SPEC = (
    "i32",
    "f32",
    "vec",
    "alive",
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
