"""recapture-hazard violation: a public host method rebinds what the
captured phase closes over, and the module's capture key never names it
(a replay would keep running the old radius)."""


class FoldModule:
    def __init__(self):
        self.radius = 4.0
        self.bucket = 8
        self.add_phase("fold", self._phase)

    def add_phase(self, name, fn):
        pass

    def capture_key(self):
        return {"bucket": self.bucket}

    def set_radius(self, r):
        self.radius = r  # captured below, named by no capture key

    def set_bucket(self, b):
        self.bucket = b  # named by capture_key(): a change re-captures

    def _phase(self, state, ctx):
        return state * self.radius + self.bucket
