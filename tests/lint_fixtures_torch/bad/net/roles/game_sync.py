"""serve-loop violation across the split role: a mixin method that the
encode stage in game.py calls iterates the session set."""


class GameSyncMixin:
    def _sync_rows(self, cname):
        # violation: reached from game.py's 'encode' stage
        for key, sess in self.sessions.items():
            self._send_one(sess)
