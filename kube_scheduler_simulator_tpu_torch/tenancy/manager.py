"""The session plane: N isolated simulations in one process.

A :class:`SessionManager` owns named sessions, each a full
:class:`~kube_scheduler_simulator_tpu_torch.server.di.DIContainer` — its own
``ClusterStore`` (own resourceVersions, event log, watch epoch), its own
``SchedulerService`` (own queue, result annotations, plugin weights),
controllers, snapshot/reset services.  What sessions deliberately SHARE
is the process-wide kernel state: the kernel libraries, built and loaded
once a process, and the substrate of resolved entries and compaction
plans (tenancy/substrate.py), so tenant k+1 builds and loads nothing.

The port's copy of the JAX package's ``tenancy/manager.py``.  Every
session's container runs on the device of the container that made it (the
card unless the boot container was built with ``device="cpu"``).  One
difference: ``close`` re-raises the first error a session's container
raised on its way down (a scheduler loop that died of a kernel error),
after every container is down, where the reference swallows it.

Lifecycle discipline (the knobs are validated here, loudly):

- ``KSS_MAX_SESSIONS``: admission cap; ``create`` past it raises
  :class:`TooManySessionsError`, which the HTTP layer maps to 429.
- ``KSS_SESSION_TTL_S``: idle TTL; sessions untouched for longer are
  reaped by :meth:`sweep` (called on every session CRUD, and cheap
  enough to call anywhere).  The default session never expires.
- destroy drains in-flight streamed waves through the scheduler's
  existing ``pause_streams`` seam before tearing the container down, so
  a tenant deletion can never abandon a half-committed wave.

Durability: with ``KSS_JOURNAL_DIR`` set, each session journals into
its own namespace ``<dir>/sessions/<id>`` (a manifest ``session.json``
records the boot parameters) and the manager's constructor re-creates
every manifest's session through the normal DIContainer boot — which
replays that namespace's journal — so a crashed multi-tenant server
comes back with EVERY tenant's store restored, not just the default
one.  Explicit destroy removes the namespace; process death does not.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable

Obj = dict[str, Any]

DEFAULT_SESSION = "default"
DEFAULT_MAX_SESSIONS = 16
_ID_RE = re.compile(r"^[a-z0-9][a-z0-9-]{0,62}$")
MANIFEST = "session.json"


class SessionError(Exception):
    """Base class for session-plane admission/lookup failures."""


class InvalidSessionError(SessionError):
    """Malformed or reserved session id (HTTP 400)."""


class SessionExistsError(SessionError):
    """Create of an id that is already live (HTTP 409)."""


class UnknownSessionError(SessionError):
    """Routing or CRUD against an id that does not exist (HTTP 404)."""


class TooManySessionsError(SessionError):
    """Admission past KSS_MAX_SESSIONS (HTTP 429)."""


def session_knobs() -> Obj:
    """The documented ``KSS_SESSION_*`` env knobs, validated so a typo
    fails loudly at manager construction (docs/environment-variables.md;
    docs/multitenancy.md)."""
    ttl_raw = os.environ.get("KSS_SESSION_TTL_S", "").strip()
    ttl_s = 0.0
    if ttl_raw:
        try:
            ttl_s = float(ttl_raw)
        except ValueError:
            raise SessionError(
                f"KSS_SESSION_TTL_S must be a number of seconds >= 0, got {ttl_raw!r}"
            ) from None
        if ttl_s < 0:
            raise SessionError(f"KSS_SESSION_TTL_S must be >= 0, got {ttl_raw!r}")
    max_raw = os.environ.get("KSS_MAX_SESSIONS", "").strip()
    max_sessions = DEFAULT_MAX_SESSIONS
    if max_raw:
        try:
            max_sessions = int(max_raw)
        except ValueError:
            raise SessionError(
                f"KSS_MAX_SESSIONS must be an integer >= 1, got {max_raw!r}"
            ) from None
        if max_sessions < 1:
            raise SessionError(f"KSS_MAX_SESSIONS must be >= 1, got {max_raw!r}")
    return {"ttl_s": ttl_s, "max_sessions": max_sessions}


class Session:
    __slots__ = ("id", "di", "use_batch", "seed", "created_wall", "last_used")

    def __init__(self, id: str, di: Any, use_batch: str, seed: int, created_wall: float, now: float):
        self.id = id
        self.di = di
        self.use_batch = use_batch
        self.seed = seed
        self.created_wall = created_wall
        self.last_used = now


class SessionManager:
    """Create/destroy/route isolated sessions over one shared substrate.

    ``default_di`` is the boot container — it IS the ``default``
    session: never created, never destroyed, never expired, and every
    un-prefixed route keeps hitting it byte-for-byte.
    """

    def __init__(
        self,
        default_di: Any,
        clock: "Callable[[], float] | None" = None,
        use_batch: str = "auto",
        start_background: bool = False,
        recover: bool = True,
    ):
        from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE

        knobs = session_knobs()
        self.ttl_s: float = knobs["ttl_s"]
        self.max_sessions: int = knobs["max_sessions"]
        # the substrate engages for the manager's lifetime, so even the
        # DEFAULT session's launches publish — tenant 1 with the boot
        # config admits warm
        SUBSTRATE.enable()
        self._substrate_held = True
        self.default_di = default_di
        self.use_batch_default = use_batch
        self.start_background = start_background
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._sessions: dict[str, Session] = {}
        # lifecycle counters (rendered on /metrics once the plane is used)
        self.created = 0
        self.destroyed = 0
        self.expired = 0
        self.rejected = 0
        self.recovered = 0
        self.ever_used = False
        # per-session journal namespaces live under the DEFAULT journal
        # directory — one tree to back up, one tree recovery walks
        self.journal_root: "str | None" = getattr(default_di, "journal_dir", None)
        if recover and self.journal_root:
            self._recover_sessions()

    # ----------------------------------------------------------- internals

    def _sessions_dir(self) -> "str | None":
        return os.path.join(self.journal_root, "sessions") if self.journal_root else None

    def _namespace(self, session_id: str) -> "str | None":
        root = self._sessions_dir()
        return os.path.join(root, session_id) if root else None

    def _build_di(self, session_id: str, use_batch: str, seed: int, scheduler_cfg: "Obj | None"):
        from kube_scheduler_simulator_tpu_torch.server.di import DIContainer

        di = DIContainer(
            initial_scheduler_cfg=scheduler_cfg,
            use_batch=use_batch,
            seed=seed,
            # a nested operator per tenant would be recursion bait — the
            # same reasoning as the KEP-159/184 ephemeral containers
            enable_simulator_operator=False,
            journal_dir=self._namespace(session_id),
            device=self.default_di.device,
        )
        if self.start_background:
            di.scheduler_service().start_background()
        return di

    def _recover_sessions(self) -> None:
        """Boot-time restore: every manifest under the sessions tree
        becomes a live session again, its store replayed from its own
        journal namespace by the DIContainer's normal recovery path."""
        root = self._sessions_dir()
        if root is None or not os.path.isdir(root):
            return
        for session_id in sorted(os.listdir(root)):
            path = os.path.join(root, session_id, MANIFEST)
            if not os.path.isfile(path):
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue  # a torn manifest names nothing recoverable
            use_batch = manifest.get("useBatch") or self.use_batch_default
            seed = int(manifest.get("seed") or 0)
            di = self._build_di(session_id, use_batch, seed, None)
            now = self._clock()
            # lock-free: runs only from __init__, before the manager is
            # published to any other thread
            self._sessions[session_id] = Session(
                session_id, di, use_batch, seed,
                float(manifest.get("createdAt") or 0.0), now,
            )
            self.recovered += 1
            self.ever_used = True  # lock-free: __init__-only, see above

    # -------------------------------------------------------------- create

    def create(
        self,
        session_id: "str | None" = None,
        use_batch: "str | None" = None,
        seed: int = 0,
        scheduler_cfg: "Obj | None" = None,
    ) -> Obj:
        with self._lock:
            self.sweep()
            if session_id is None:
                n = self.created
                while f"s-{n}" in self._sessions:
                    n += 1
                session_id = f"s-{n}"
            if session_id == DEFAULT_SESSION:
                raise InvalidSessionError(
                    "'default' is the boot container's session — it always exists"
                )
            if not _ID_RE.match(session_id):
                raise InvalidSessionError(
                    f"session id must match {_ID_RE.pattern}, got {session_id!r}"
                )
            if session_id in self._sessions:
                raise SessionExistsError(f"session {session_id!r} already exists")
            if len(self._sessions) >= self.max_sessions:
                self.rejected += 1
                raise TooManySessionsError(
                    f"session cap reached (KSS_MAX_SESSIONS={self.max_sessions}); "
                    "destroy one or raise the cap"
                )
            use_batch = use_batch or self.use_batch_default
            if use_batch not in ("off", "auto", "force"):
                raise InvalidSessionError(
                    f"useBatch must be off|auto|force, got {use_batch!r}"
                )
            created_wall = time.time()
            ns = self._namespace(session_id)
            if ns is not None:
                # manifest lands BEFORE the container boots: a crash
                # mid-create recovers an empty-but-present session, never
                # an orphaned journal namespace nothing re-adopts
                os.makedirs(ns, exist_ok=True)
                with open(os.path.join(ns, MANIFEST), "w", encoding="utf-8") as f:
                    json.dump(
                        {"id": session_id, "useBatch": use_batch, "seed": seed,
                         "createdAt": created_wall},
                        f,
                    )
            di = self._build_di(session_id, use_batch, int(seed), scheduler_cfg)
            s = Session(session_id, di, use_batch, int(seed), created_wall, self._clock())
            self._sessions[session_id] = s
            self.created += 1
            self.ever_used = True
            return self.info(s)

    # ------------------------------------------------------------- destroy

    def destroy(self, session_id: str, purge: bool = True, _expired: bool = False) -> None:
        with self._lock:
            if session_id == DEFAULT_SESSION:
                raise InvalidSessionError("the default session cannot be destroyed")
            s = self._sessions.pop(session_id, None)
            if s is None:
                raise UnknownSessionError(f"no session {session_id!r}")
            # drain first: in-flight streamed waves commit or park before
            # the container's services disappear under them
            try:
                with s.di.scheduler_service().pause_streams("session destroy"):
                    pass
            finally:
                s.di.close()
            ns = self._namespace(session_id)
            if purge and ns is not None and os.path.isdir(ns):
                # explicit destroy forgets the tenant durably — recovery
                # must not resurrect it
                shutil.rmtree(ns, ignore_errors=True)
            if _expired:
                self.expired += 1
            else:
                self.destroyed += 1

    def sweep(self) -> int:
        """Reap idle-expired sessions; returns how many went."""
        if self.ttl_s <= 0:
            return 0
        with self._lock:
            now = self._clock()
            stale = [
                sid for sid, s in self._sessions.items()
                if now - s.last_used > self.ttl_s
            ]
            for sid in stale:
                self.destroy(sid, purge=True, _expired=True)
            return len(stale)

    def close(self) -> None:
        """Server shutdown: tear containers down, KEEP journal
        namespaces — only an explicit destroy forgets a tenant."""
        first: "Exception | None" = None
        with self._lock:
            for s in list(self._sessions.values()):
                try:
                    s.di.close()
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    first = first or exc
            self._sessions.clear()
            if self._substrate_held:
                from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE

                SUBSTRATE.disable()
                self._substrate_held = False
        if first is not None:
            raise first

    # ------------------------------------------------------------- routing

    def get(self, session_id: str) -> Session:
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                raise UnknownSessionError(f"no session {session_id!r}")
            s.last_used = self._clock()
            return s

    def resolve_di(self, session_id: "str | None"):
        """The routing seam: '' / None / 'default' → the boot container;
        anything else → that session's container (touching its TTL
        clock) or :class:`UnknownSessionError`."""
        if not session_id or session_id == DEFAULT_SESSION:
            return self.default_di
        return self.get(session_id).di

    def resolve_store(self, session_id: "str | None"):
        """Same, for the kube-API port (store-only surface)."""
        return self.resolve_di(session_id).cluster_store

    # ------------------------------------------------------------- surface

    def info(self, s: Session) -> Obj:
        now = self._clock()
        return {
            "id": s.id,
            "useBatch": s.use_batch,
            "seed": s.seed,
            "createdAt": s.created_wall,
            "idleSeconds": round(max(0.0, now - s.last_used), 3),
            "journalNamespace": self._namespace(s.id),
        }

    def list(self) -> "list[Obj]":
        with self._lock:
            self.sweep()
            return [self.info(s) for _, s in sorted(self._sessions.items())]

    def ids(self) -> "list[str]":
        with self._lock:
            return sorted(self._sessions)

    def stats(self) -> Obj:
        with self._lock:
            return {
                "sessions_active": len(self._sessions),
                "sessions_created_total": self.created,
                "sessions_destroyed_total": self.destroyed,
                "sessions_expired_total": self.expired,
                "sessions_rejected_total": self.rejected,
                "sessions_recovered_total": self.recovered,
                "session_ttl_s": self.ttl_s,
                "max_sessions": self.max_sessions,
            }
