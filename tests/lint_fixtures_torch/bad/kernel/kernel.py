"""Bad fixture for train-lanes-covered: Kernel._step grew an `aggro`
lane the train spec never learned about, and the spec still names a
`casts` lane that a kernel refactor deleted."""

TRAIN_LANE_SPEC = (
    "fired",
    "diff",
    "died",
    "casts",  # <- stale: no such lane anymore
    "summary",
)

TRAIN_EXCLUDED = ()


class Kernel:
    def _step(self, state, observe=True):
        fired = diff = died = aggro = summary = state
        if not observe:
            return state, None
        raw = {
            "fired": fired,
            "diff": diff,
            "died": died,
            "aggro": aggro,  # <- unlisted: a train would drop its history
            "summary": summary,
        }
        return state, raw
