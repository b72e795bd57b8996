"""Clean write-behind shape: pump surface queues, flusher stores."""


class WriteBehindPipeline:
    def __init__(self, backend, wal):
        self.backend = backend
        self.wal = wal
        self.queue = []

    # -- pump-thread surface ----------------------------------------------

    def enqueue(self, batch):
        self.queue.extend(batch)

    def enqueue_one(self, rec):
        self.queue.append(rec)

    def note_tick(self, tick):
        self.tick = tick

    def barrier(self):
        self.wal.sync()  # the ONE place durability is paid for

    def pump(self):
        return list(self.queue)

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
