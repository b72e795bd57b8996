"""Device launches (kernel, copy and fill nodes) of one replay of the
captured step that the traffic's entry replays, as the cost book counts
them."""


def read(run):
    n = run["launches"]
    return None if n is None else float(n)
