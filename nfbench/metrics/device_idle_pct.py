"""The share of a frame in which no kernel, copy or fill ran on the card:
the device's busy seconds a frame, from the traced frames, over the mean
wall time of the same run's untraced frames.  The profiler slows each
graph launch on the host, so a traced frame lasts longer than an
untraced one, and the traced frames' own wall span would count the
profiler's time as the program's idle time."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["busy_s"] <= 0 or not tr["frames"]:
        return None
    lo, hi = run["traced_frames"]
    untraced = run["frame_s"][:lo] + run["frame_s"][hi:]
    if not untraced:
        return None
    frame_s = sum(untraced) / len(untraced)
    return 100.0 * (1.0 - tr["busy_s"] / tr["frames"] / frame_s)
