"""Clean ParkingBuffer: pure in-memory bookkeeping, never blocks."""


class ParkingBuffer:
    def __init__(self):
        self.parked = {}

    def park(self, key, frame):
        self.parked.setdefault(key, []).append(frame)

    def expire(self, now):
        return []

    def replay(self, key):
        return self.parked.pop(key, [])

    def discard(self, key):
        self.parked.pop(key, None)

    def depth(self, key):
        return len(self.parked.get(key, ()))

    def keys(self):
        return list(self.parked)
