"""Clean journal tap: sidecar opcodes filtered before the journal.
Clean serve path: per-session work only in the 'assemble' stage."""

TRACE_MSG_IDS = frozenset({900, 901})


class GameRole:
    def __init__(self, journal):
        self.journal = journal

    def _journal_tap(self):
        def tap(conn_id, msg_id, payload):
            if msg_id not in TRACE_MSG_IDS:
                self.journal.event(conn_id, msg_id, payload)

        return tap


class ServeRole:
    """Batched serve shape: hot stages are loop-free; the emission
    loop lives under the sanctioned 'assemble' stage."""

    def __init__(self, stage_clock):
        self.stage_clock = stage_clock
        self.sessions = {}

    def _flush_changes(self):
        sc = self.stage_clock
        with sc.stage("interest"):
            data = self._collect("NPC")
        with sc.stage("encode"):
            self._send_batch("NPC", data)
            self._sync_rows("NPC")  # defined on a mixin in game_sync.py

    def _collect(self, cname):
        # loop over classes/chunks, not sessions: fine in a hot stage
        parts = []
        for chunk in range(4):
            parts.append(self._scan(cname, chunk))
        return parts

    def _send_batch(self, cname, data):
        with self.stage_clock.stage("assemble"):
            # per-session packet slicing belongs to 'assemble'
            for key, sess in self.sessions.items():
                self._send_one(sess, data)

    def _scan(self, cname, chunk):
        return chunk

    def _send_one(self, sess, data):
        pass
