"""Good fixture for train-lanes-covered: every Kernel._step lane is
enumerated by the train spec or waivered with a reason, nothing stale."""

TRAIN_LANE_SPEC = (
    "fired",
    "diff",
    "died",
    "summary",
)

# scratch.* lanes are capture-debug only, never consumed by host code
TRAIN_EXCLUDED = ("scratch.debug",)


class Kernel:
    def _step(self, state, observe=True):
        fired = diff = died = summary = scratch = state
        if not observe:
            return state, None
        raw = {
            "fired": fired,
            "diff": diff,
            "died": died,
            "scratch.debug": scratch,
            "summary": summary,
        }
        return state, raw
