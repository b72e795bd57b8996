"""Clean mixin of the split role: the method game.py's encode stage
calls does per-session work only under the 'assemble' stage."""


class GameSyncMixin:
    def _sync_rows(self, cname):
        with self.stage_clock.stage("assemble"):
            for key, sess in self.sessions.items():
                self._send_one(sess, cname)
