"""Good fixture for room-axis-covered: every WorldState leaf is
enumerated by the room pack spec or waivered (aux caches are rebuilt
blank on admit), nothing stale."""

ROOM_PACK_SPEC = (
    "tick",
    "rng",
    "classes.*.i32",
    "classes.*.f32",
    "classes.*.vec",
    "classes.*.alive",
    "classes.*.timers.next_fire",
    "classes.*.timers.interval",
    "classes.*.timers.remain",
    "classes.*.timers.active",
    "classes.*.records.*.i32",
    "classes.*.records.*.f32",
    "classes.*.records.*.vec",
    "classes.*.records.*.used",
)

ROOM_EXCLUDED = ("aux.*",)
