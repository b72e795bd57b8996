"""Bad fixture for room-axis-covered: WorldState grew an `era` leaf
(and ClassState a `shadow` bank) the room pack spec never learned
about, and the spec still names a `classes.*.mana` bank that a store
refactor deleted."""

ROOM_PACK_SPEC = (
    "tick",
    "rng",
    "classes.*.i32",
    "classes.*.f32",
    "classes.*.vec",
    "classes.*.alive",
    "classes.*.mana",  # <- stale: no such ClassState bank anymore
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
