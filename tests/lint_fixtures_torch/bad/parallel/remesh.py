"""mesh-not-captured violation: a phase reads the mesh through object
state — the capture pins whatever device set `self.mesh` held, so an
elastic reshard leaves a stale graph behind."""


def shard_step(state, mesh):
    return state, mesh


class BadMigrate:
    def __init__(self, mesh):
        self.mesh = mesh
        self.add_phase("migrate", self._migrate, order=20)

    def add_phase(self, name, fn, order=0):
        pass

    def _migrate(self, state, ctx):
        return shard_step(state, self.mesh)  # captured via object state
