from kube_scheduler_simulator_tpu_torch.state.store import (
    KINDS,
    NAMESPACED_KINDS,
    ClusterStore,
    Event,
    NotFoundError,
    AlreadyExistsError,
    ResourceExpiredError,
)
from kube_scheduler_simulator_tpu_torch.state.journal import (
    Journal,
    JournalError,
    journal_from_env,
    journal_knobs,
)
from kube_scheduler_simulator_tpu_torch.state.recovery import (
    RecoveryManager,
    RecoveryReport,
    boot_recover,
    build_checkpoint,
    restore_scheduler_state,
    scheduler_meta_provider,
    write_mark,
)

__all__ = [
    "KINDS",
    "NAMESPACED_KINDS",
    "ClusterStore",
    "Event",
    "NotFoundError",
    "AlreadyExistsError",
    "ResourceExpiredError",
    "Journal",
    "JournalError",
    "journal_from_env",
    "journal_knobs",
    "RecoveryManager",
    "RecoveryReport",
    "boot_recover",
    "build_checkpoint",
    "restore_scheduler_state",
    "scheduler_meta_provider",
    "write_mark",
]
