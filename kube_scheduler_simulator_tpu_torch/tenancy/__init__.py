"""Multi-tenant session plane (docs/multitenancy.md).

Isolated per-session control planes — store, scheduler, queue, watch
epoch, journal namespace — over ONE shared kernel substrate: the port
builds and loads its kernel libraries once a process, and every session
resolves its kernel entries and compaction plans through one registry.
"""

from kube_scheduler_simulator_tpu_torch.tenancy.manager import (
    DEFAULT_SESSION,
    InvalidSessionError,
    Session,
    SessionError,
    SessionExistsError,
    SessionManager,
    TooManySessionsError,
    UnknownSessionError,
    session_knobs,
)
from kube_scheduler_simulator_tpu_torch.tenancy.substrate import SUBSTRATE, ExecutableSubstrate

__all__ = [
    "DEFAULT_SESSION",
    "ExecutableSubstrate",
    "InvalidSessionError",
    "SUBSTRATE",
    "Session",
    "SessionError",
    "SessionExistsError",
    "SessionManager",
    "TooManySessionsError",
    "UnknownSessionError",
    "session_knobs",
]
