"""pump-surface + fsync-barrier violations on the write-behind shape."""
import time


class WriteBehindPipeline:
    def __init__(self, backend, wal):
        self.backend = backend
        self.wal = wal
        self.queue = []

    # -- pump-thread surface (must never store/sleep) ---------------------

    def enqueue(self, batch):
        self.backend.put_many(batch)  # store call on the pump surface

    def enqueue_one(self, rec):
        self.queue.append(rec)

    def note_tick(self, tick):
        self.wal.sync()  # per-tick fsync (fsync-barrier)

    def barrier(self):
        self.wal.sync()  # allowed: barrier owns durability

    def pump(self):
        time.sleep(0.01)  # sleep on the pump surface

    def pending(self):
        return len(self.queue)

    def discard(self):
        self.queue.clear()

    def lag_ticks(self):
        return 0

    def queue_depth(self):
        return len(self.queue)

    def degraded(self):
        return False

    # -- flusher thread ---------------------------------------------------

    def _flush_batch(self, batch):
        self.backend.put_many(batch)
