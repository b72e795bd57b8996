"""ParkingBuffer blocking-call violation (pump-surface rule)."""
import time


class ParkingBuffer:
    def __init__(self):
        self.parked = {}

    def park(self, key, frame):
        time.sleep(0.001)  # blocking call on the parking path
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
