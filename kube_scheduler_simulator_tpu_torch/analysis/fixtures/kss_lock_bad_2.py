"""KSS-LOCK bad fixture 2: collaborator locks and subscript aliases."""

import threading


class Service:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self.stats = {"drains": {}}


class Session:
    def __init__(self, service):
        self.svc = service

    def count_drain(self, reason):
        with self.svc._stats_lock:
            d = self.svc.stats["drains"]
            d[reason] = d.get(reason, 0) + 1

    def note_wave(self):
        self.svc.stats["waves"] = self.svc.stats.get("waves", 0) + 1  # expect-finding

    def fast_path(self, reason):
        svc = self.svc  # alias: accesses canonicalize through it
        svc.stats["fast"] = 1  # expect-finding


class TwoLocks:
    """A helper called under lock B is NOT thereby held under lock A —
    the closure must track (lock, callee) pairs, not a flat callee set."""

    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self.guarded = 0

    def write_a(self):
        with self._a_lock:
            self.guarded = 1

    def helper_under_b(self):
        with self._b_lock:
            self._read_guarded()

    def _read_guarded(self):
        return self.guarded  # expect-finding
