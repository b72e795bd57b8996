"""journal-tap-guard violation: trace sidecars reach the journal.
serve-loop violations: session loops inside hot serve stages."""

TRACE_MSG_IDS = frozenset({900, 901})


class GameRole:
    def __init__(self, journal):
        self.journal = journal

    def _journal_tap(self):
        def tap(conn_id, msg_id, payload):
            # unguarded: FRAME_TRACE sidecars enter the journal and
            # replay diverges between traced and untraced runs
            self.journal.event(conn_id, msg_id, payload)

        return tap


class ServeRole:
    """serve-loop: per-session Python work inside 'interest'/'encode'."""

    def __init__(self, stage_clock):
        self.stage_clock = stage_clock
        self.sessions = {}

    def _flush_changes(self):
        sc = self.stage_clock
        with sc.stage("interest"):
            # violation: lexical session loop in the interest stage
            for key, sess in self.sessions.items():
                self._send_one(sess)
        with sc.stage("encode"):
            self._send_batch("NPC")
            self._sync_rows("NPC")  # defined on a mixin in game_sync.py

    def _send_batch(self, cname):
        # violation: reached from the encode stage; iterates the
        # _observer_arrays alias of the session set
        obs, obs_rows, obs_valid = self._observer_arrays()
        for i, sess in enumerate(obs):
            self._send_one(sess)

    def _observer_arrays(self):
        return list(self.sessions.values()), None, None

    def _send_one(self, sess):
        pass
