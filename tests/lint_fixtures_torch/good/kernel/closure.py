"""Clean closure: everything a public host method rebinds and the
captured phase reads is named by the capture key."""


class FoldModule:
    def __init__(self):
        self.radius = 4.0
        self.bucket = 8
        self.add_phase("fold", self._phase)

    def add_phase(self, name, fn):
        pass

    def capture_key(self):
        return {"bucket": self.bucket, "radius": self._radius_key()}

    def _radius_key(self):
        return self.radius

    def set_radius(self, r):
        self.radius = r

    def set_bucket(self, b):
        self.bucket = b

    def _phase(self, state, ctx):
        return state * self.radius + self.bucket
