"""KSS-LOCK good fixture: lock discipline, transitive helpers, and the
justified lock-free escape hatch — silent."""

import threading


class Cache:
    def __init__(self):
        self._lock = threading.RLock()
        self.stats = {"hits": 0}
        self.table = {}

    def update(self, key, value):
        with self._lock:
            self._apply(key, value)

    def _apply(self, key, value):
        # called only under the lock (transitive closure covers it)
        self.table[key] = value
        self.stats["hits"] = self.stats["hits"] + 1

    def get(self, key):
        with self._lock:
            return self.table.get(key)

    def stats_snapshot(self):
        # lock-free: copy-on-write publish — values are replaced, never
        # mutated in place, so a GIL-atomic dict copy needs no lock
        return dict(self.stats)
