"""KSS-LOCK bad fixture 1: guarded state touched outside the lock."""

import threading


class Cache:
    def __init__(self):
        self._lock = threading.RLock()
        self.stats = {"hits": 0, "misses": 0}
        self.table = {}

    def update(self, key, value):
        with self._lock:
            self.table[key] = value
            self.stats["hits"] = self.stats["hits"] + 1

    def peek(self, key):
        # unlocked read of lock-guarded state, no justification
        return self.table.get(key)  # expect-finding

    def bump_miss(self):
        # unlocked WRITE of lock-guarded state
        self.stats["misses"] += 1  # expect-finding
