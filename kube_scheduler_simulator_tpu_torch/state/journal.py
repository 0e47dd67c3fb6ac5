"""Write-ahead journal: crash durability for the in-memory control plane.

The ``ClusterStore`` is the build's whole control plane (it replaces the
reference's kube-apiserver + etcd), and until this module its only
durability story was the manual snapshot export/import.  A ``Journal``
makes the store crash-consistent: every mutation event the store emits
is appended — before the process can observe a completed operation — to
an append-only, CRC-framed log under ``KSS_JOURNAL_DIR``, and
:mod:`state.recovery` replays it into a fresh process after a crash.

Design points:

- **Record framing.**  A segment file starts with an 8-byte magic
  (``KSSJRNL1``); each record is ``<u32 payload-length><u32 crc32>``
  followed by the JSON payload (sorted keys, compact separators — the
  same op sequence always produces the same bytes, which is what lets
  the torn-write fixtures commit exact files).  A torn tail — short
  header, short payload, or CRC mismatch — is detected by the reader
  and truncated by recovery (counted, never raised).
- **Wave atomicity.**  All store mutations funnel through
  ``ClusterStore._emit``; with a journal attached each event becomes a
  record.  ``ClusterStore.journal_txn`` groups the events of a bulk
  operation — a batch commit wave (``add_wave_results`` + the bind
  transaction + ``flush_wave``), a gang release, a ``bulk_update``, a
  sequential scheduling attempt — into ONE atomic record, so recovery
  can never observe a partially-committed wave or a partially-bound
  gang: a record either replays whole or (torn) is truncated whole.
- **Counters ride on every record.**  ``meta_providers`` are read at
  record-write time (under the store lock) and merged into the payload:
  the store contributes its resourceVersion/uid/generateName counters,
  the scheduler service its per-profile rotation and attempt counters.
  Recovery restores process state from the LAST record's meta, which by
  construction reflects the moment that record became durable.
- **Rotation + compaction.**  ``compact()`` snapshots the whole store
  through ``checkpoint_provider`` (which reuses
  ``SnapshotService.snap()`` — a checkpoint's ``resources`` field IS a
  ResourcesForSnap document) into ``checkpoint-<n>.ckpt``, then rotates
  to a fresh segment and deletes the segments and checkpoints the new
  checkpoint supersedes.  ``checkpoint_every`` (``KSS_CHECKPOINT_EVERY``)
  triggers it automatically every N records; 0 = boot/manual only.
- **fsync** (``KSS_JOURNAL_FSYNC``) is opt-in: the default flushes to
  the OS (surviving process death, the SIGKILL chaos model) without
  paying a disk sync per record; ``1`` syncs every record (surviving
  host power loss too).
- **Publish ordering (shipping).**  A record's header + payload are
  written as ONE buffered write followed by one flush, so a concurrent
  reader of the live segment (:mod:`replication.ship` tails it while
  the primary appends) always observes a strict PREFIX of the logical
  record stream — never reordered or interleaved frame bytes.  That
  prefix property is what makes the tailer's partial-vs-torn call
  deterministic: a short frame at the tail is a mid-write record
  (wait and re-poll), while a full-length frame whose CRC fails can
  only be real damage.  ``kill_at`` fsyncs before killing, so the
  "durable" a chaos kill publishes is the same durable a tailer reads.
- **Seal markers.**  Rotation and clean close append a ``seal`` record
  to the finished segment: a tailer that consumes a seal knows the
  segment is COMPLETE and continues at index+1; a segment superseded
  by a newer segment/checkpoint WITHOUT a seal marks a crash boundary.
  Seals are framing metadata, not state: they are excluded from
  ``stats["records"]`` and skipped (uncounted) by recovery and the
  replication applier.

- **Disk faults are policy, not stack traces.**  Append/fsync/rotation
  errors are classified by errno (ENOSPC, EIO, EROFS, …) and routed per
  ``KSS_JOURNAL_ON_ERROR``: ``wedge`` (default) raises
  :class:`JournalWedged` out of the failing commit and refuses every
  later transaction at ENTRY (before any store mutation) — the
  durability promise fails loudly; ``degrade`` counts
  ``journal_degraded_total{errno}`` once and continues NON-durable,
  with the log truncated back to the last record boundary so recovery
  and a live tailer both read a clean prefix of durable records.  All
  record bytes go through the injectable ``io`` seam so the chaos
  harness (fuzz/chaos.py ``DiskChaos``) can land a fault at an exact
  seeded record.

Everything here is opt-in: with no journal attached the store takes one
``None`` check per emit and tier-1 stays byte-for-byte today's behavior.

``kill_at`` is the crash adversary's hook (:mod:`fuzz.chaos`
``ProcessChaos``): the journal SIGKILLs its own process the instant the
N-th record is durable, which is what "SIGKILL at a seeded
journal-record index" means — deterministic, unmissable, and exactly at
a record boundary like a real mid-run kill.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import struct
import zlib
from typing import Any, Callable, Iterator

Obj = dict[str, Any]

SEGMENT_MAGIC = b"KSSJRNL1"
CHECKPOINT_MAGIC = b"KSSCKPT1"
_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
# sanity bound on a single record (a corrupt length field must not make
# the reader try to allocate gigabytes): 256 MiB
_MAX_RECORD = 256 << 20

SEAL_TYPE = "seal"

SEGMENT_PREFIX = "segment-"
SEGMENT_SUFFIX = ".kssj"
CHECKPOINT_PREFIX = "checkpoint-"
CHECKPOINT_SUFFIX = ".ckpt"


class JournalError(RuntimeError):
    """A journal WRITE-side invariant broke (bad configuration, closed
    journal).  Read-side damage is never an exception — recovery counts
    and truncates it."""


class JournalWedged(JournalError):
    """A disk fault hit the journal under ``KSS_JOURNAL_ON_ERROR=wedge``:
    the durability promise could not be kept, so the commit fails LOUDLY
    and the store refuses further mutations — every subsequent
    ``journal_txn`` raises at entry, BEFORE any store mutation.  The
    on-disk journal stays a clean prefix of durable records (the failed
    frame is truncated back to its record boundary)."""


def classify_errno(e: OSError) -> str:
    """A disk fault's errno as a stable label: the named classes the
    fault matrix drills (ENOSPC, EIO, EROFS), the symbolic name for any
    other errno, ``EUNKNOWN`` when the OSError carries none."""
    if e.errno is None:
        return "EUNKNOWN"
    return _errno.errorcode.get(e.errno, f"E{e.errno}")


class _DirectIO:
    """The journal's file-IO seam: every segment/seal byte goes through
    these three calls so the chaos harness (fuzz/chaos.py ``DiskChaos``)
    can inject ENOSPC/EIO/EROFS at a seeded record without touching a
    real filesystem's failure modes."""

    def write(self, f, data: bytes) -> None:
        f.write(data)

    def flush(self, f) -> None:
        f.flush()

    def fsync(self, fd: int) -> None:
        os.fsync(fd)


def _dumps(payload: Obj) -> bytes:
    # Compact separators, NO key sorting: replayed objects must keep
    # the live objects' dict insertion order byte-for-byte (condition
    # lists are compared as strings by the parity surface — sorting
    # keys here made a recovered pod's conditions differ from the
    # uninterrupted run's).  Determinism still holds: a deterministic
    # op sequence builds its dicts in a deterministic order, which is
    # what the byte-stable fixtures pin.
    return json.dumps(payload, separators=(",", ":")).encode("utf-8")


def segment_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"{SEGMENT_PREFIX}{index:08d}{SEGMENT_SUFFIX}")


def checkpoint_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"{CHECKPOINT_PREFIX}{index:08d}{CHECKPOINT_SUFFIX}")


def _indexed(directory: str, prefix: str, suffix: str) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    if not os.path.isdir(directory):
        return out
    for fn in os.listdir(directory):
        if fn.startswith(prefix) and fn.endswith(suffix):
            mid = fn[len(prefix) : -len(suffix)]
            if mid.isdigit():
                out.append((int(mid), os.path.join(directory, fn)))
    return sorted(out)


def list_segments(directory: str) -> list[tuple[int, str]]:
    return _indexed(directory, SEGMENT_PREFIX, SEGMENT_SUFFIX)


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    return _indexed(directory, CHECKPOINT_PREFIX, CHECKPOINT_SUFFIX)


class Journal:
    """Append-only CRC-framed write-ahead log over one directory.

    Internally locked: appends arrive both from under the store lock
    (``ClusterStore._emit``) and from outside it (transaction exits,
    config/boot records, marks) on any thread — interleaved raw file
    writes would tear records, so ``append``/``compact`` serialize on
    the journal's own mutex.
    """

    def __init__(
        self,
        directory: str,
        fsync: bool = False,
        checkpoint_every: int = 0,
        kill_at: "int | None" = None,
        on_error: str = "wedge",
        io: "Any | None" = None,
    ):
        self.directory = directory
        self.fsync = bool(fsync)
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_every < 0:
            raise JournalError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if on_error not in ("wedge", "degrade"):
            raise JournalError(
                f"on_error must be 'wedge' or 'degrade', got {on_error!r}"
            )
        # disk-fault policy (KSS_JOURNAL_ON_ERROR): 'wedge' fails the
        # commit loudly and refuses further mutations; 'degrade' counts
        # the errno and continues NON-DURABLE (appends become no-ops)
        # with the on-disk log truncated back to a record boundary so
        # recovery and a live tailer both read a clean prefix.
        self.on_error = on_error
        self.io = io if io is not None else _DirectIO()
        self.wedged = False
        self.degraded_errno: "str | None" = None
        self.degraded_by_errno: dict[str, int] = {}
        # test/chaos hook: SIGKILL this process once record #kill_at
        # (1-based) is durable (fuzz.chaos.ProcessChaos)
        self.kill_at = kill_at
        # read at record-write time and merged into the payload's "meta"
        self.meta_providers: list[Callable[[], Obj]] = []
        # called (no args) by compact(); returns the checkpoint payload
        self.checkpoint_provider: "Callable[[], Obj] | None" = None
        # the newest "mark" record's resume state: compaction may delete
        # the segment holding it, so every checkpoint embeds a copy —
        # recovery must never lose its resume point to a rotation.
        # A post-recovery epoch seeds it from the RecoveryReport (a
        # compaction BEFORE the resumed run's first mark must not prune
        # the only durable resume point).
        self.last_mark: "Obj | None" = None
        # last FULL meta emitted (append writes per-record deltas)
        self._last_meta: Obj = {}
        # set by ClusterStore.attach_journal: appends and compactions
        # serialize on the STORE lock (one total order for record bytes
        # AND their meta deltas — without it, two appenders could write
        # records in the opposite order to their delta computation and
        # recovery's meta merge would restore stale process state), and
        # compaction defers while any journal_txn is open (a checkpoint
        # must never snapshot a half-applied wave).
        self.append_lock: Any = None
        self.compaction_gate: "Callable[[], bool] | None" = None
        import threading

        self._mu = threading.Lock()
        self.stats: dict[str, int] = {
            "records": 0,
            "bytes": 0,
            "compactions": 0,
            "fsyncs": 0,
            "seals": 0,
            "wedges": 0,
            "records_dropped": 0,  # appends skipped while degraded
        }
        os.makedirs(directory, exist_ok=True)
        segs = list_segments(directory)
        self._seg_index = (segs[-1][0] + 1) if segs else 1
        self._records_since_checkpoint = 0
        self._f = self._open_segment(self._seg_index)
        self._closed = False

    # ------------------------------------------------------------------ write

    def _open_segment(self, index: int):
        f = open(segment_path(self.directory, index), "ab")
        if f.tell() == 0:
            f.write(SEGMENT_MAGIC)
            f.flush()
        return f

    def check_writable(self) -> None:
        """Raise :class:`JournalWedged` once a wedge-mode disk fault has
        hit.  ``ClusterStore.journal_txn`` calls this at transaction
        ENTRY: after the first loud failure, no further store mutation
        even begins against a journal that cannot make it durable."""
        if self.wedged:
            raise JournalWedged(
                "journal is wedged after a disk fault (KSS_JOURNAL_ON_ERROR=wedge): "
                "refusing further mutations"
            )

    def _handle_write_error(self, e: OSError, boundary: int) -> None:
        """Route a disk fault per ``on_error`` — called under ``_mu``
        with ``boundary`` the offset of the last durable record edge.
        Both policies first truncate the maybe-partial frame back to the
        boundary so the on-disk log stays a clean prefix of durable
        records; if even the truncate fails, the leftover partial tail
        is exactly the shape recovery and the tailer already classify
        (torn, counted, stepped over) — the logical prefix stays clean
        either way."""
        label = classify_errno(e)
        try:
            self._f.truncate(boundary)
            self._f.seek(boundary)
        except (OSError, ValueError):
            pass
        if self.on_error == "degrade":
            self.degraded_errno = label
            self.degraded_by_errno[label] = self.degraded_by_errno.get(label, 0) + 1
            return
        self.wedged = True
        self.stats["wedges"] += 1
        raise JournalWedged(
            f"journal write failed ({label}) under KSS_JOURNAL_ON_ERROR=wedge: "
            "the commit is NOT durable — refusing this and all further mutations"
        ) from e

    def add_meta_provider(self, provider: Callable[[], Obj]) -> None:
        self.meta_providers.append(provider)

    def _meta(self) -> Obj:
        meta: Obj = {}
        for p in self.meta_providers:
            meta.update(p())
        return meta

    def _meta_delta(self) -> Obj:
        """The meta fields that CHANGED since the last appended record.
        Meta can be O(cluster) (the scheduling queue snapshot); a churn
        run must not pay those bytes on every record, so recovery MERGES
        records' meta — an omitted key means "same as before".
        Checkpoints always embed the FULL meta (they are a fresh base:
        everything before them is pruned).  Bookkeeping races between
        concurrent appenders can at worst re-emit an unchanged field."""
        full = self._meta()
        prev = self._last_meta
        delta = {k: v for k, v in full.items() if k not in prev or prev[k] != v}
        self._last_meta = full
        return delta

    def append(self, rtype: str, events: "list | None" = None, extra: "Obj | None" = None) -> None:
        """Append one durable record.  ``events`` is a list of
        ``[kind, event_type, obj]`` triples (the store's emit stream);
        ``extra`` carries record-type-specific fields (a mark's tick, a
        config record's scheduler configuration).

        Lock order: ``append_lock`` (the store lock, when attached)
        FIRST — it serializes payload/meta-delta construction with the
        write order; meta providers re-take the store/queue locks
        reentrantly inside it; ``_mu`` (file writes only) LAST.  Taking
        the store lock while holding ``_mu`` would deadlock against the
        ``_emit`` path (store lock → append)."""
        import contextlib

        with self.append_lock if self.append_lock is not None else contextlib.nullcontext():
            self._append_ordered(rtype, events, extra)

    def _append_ordered(self, rtype: str, events: "list | None", extra: "Obj | None") -> None:
        payload: Obj = {"t": rtype, "meta": self._meta_delta()}
        if events:
            payload["events"] = events
        if extra:
            payload["x"] = extra
        data = _dumps(payload)
        compact_due = False
        with self._mu:
            if self._closed:
                raise JournalError("journal is closed")
            self.check_writable()
            if self.degraded_errno is not None:
                # non-durable continuation: the fault was counted when it
                # hit; further records drop (counted) so the on-disk
                # prefix stays exactly the pre-fault durable stream
                self.stats["records_dropped"] += 1
                return
            # ONE write for the whole frame, then one flush: a concurrent
            # tailer of the live segment sees a strict prefix of the
            # record stream, never a header published ahead of its
            # payload (replication/ship.py leans on this)
            boundary = self._f.tell()
            frame = _HEADER.pack(len(data), zlib.crc32(data) & 0xFFFFFFFF) + data
            try:
                self.io.write(self._f, frame)
                self.io.flush(self._f)
                if self.fsync:
                    self.io.fsync(self._f.fileno())
                    self.stats["fsyncs"] += 1
            except OSError as e:
                self._handle_write_error(e, boundary)
                return
            if rtype == "mark":
                self.last_mark = extra
            self.stats["records"] += 1
            self.stats["bytes"] += _HEADER.size + len(data)
            self._records_since_checkpoint += 1
            if self.kill_at is not None and self.stats["records"] >= self.kill_at:
                # the chaos adversary: die the instant this record is
                # durable (fsync even when the knob is off — the kill
                # point must not itself tear the record it is keyed on)
                os.fsync(self._f.fileno())
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            compact_due = (
                self.checkpoint_every > 0
                and self.checkpoint_provider is not None
                and self._records_since_checkpoint >= self.checkpoint_every
            )
        if compact_due:
            # still inside append_lock: the checkpoint cannot interleave
            # with other threads' mutations or open transactions
            self.compact()

    # ---------------------------------------------------------- compaction

    def compact(self) -> "str | None":
        """Snapshot the whole store into a checkpoint, rotate to a fresh
        segment, and delete everything the checkpoint supersedes.  The
        checkpoint is written and synced BEFORE any deletion, so a crash
        at any point leaves either (old segments + maybe the new
        checkpoint) or (new checkpoint + fresh segment) — recovery picks
        the newest valid checkpoint and replays segments >= its index
        (the stale-checkpoint fixture pins this).

        The checkpoint payload + meta are built under ``append_lock``
        (their providers take the store lock — see the lock-order note
        on ``append``); only the file rotation holds ``_mu``.  While
        any ``journal_txn`` is open (``compaction_gate`` false) the
        compaction DEFERS — its mutations are already in the store, so
        a checkpoint taken mid-transaction would persist a half-applied
        wave the journal promises can never be observed; the pending
        ``checkpoint_every`` threshold retries at the next append."""
        import contextlib

        with self.append_lock if self.append_lock is not None else contextlib.nullcontext():
            if self.checkpoint_provider is None:
                return None
            if self.compaction_gate is not None and not self.compaction_gate():
                return None
            payload = self.checkpoint_provider()
            meta = self._meta()
            return self._write_checkpoint(payload, meta)

    def _seal_locked(self) -> None:
        """Append the segment-sealed marker (``{"t": "seal"}``) to the
        CURRENT segment — called under ``_mu`` at rotation and clean
        close.  A tailer that reads a seal knows the segment is
        complete and continues at the next index; damage after a seal,
        or a superseded segment without one, is a crash, not a
        mid-write tail.  Framing metadata only: not counted in
        ``stats["records"]``, skipped by recovery and replication."""
        if self.wedged or self.degraded_errno is not None:
            return
        data = _dumps({"t": SEAL_TYPE})
        boundary = self._f.tell()
        frame = _HEADER.pack(len(data), zlib.crc32(data) & 0xFFFFFFFF) + data
        try:
            self.io.write(self._f, frame)
            self.io.flush(self._f)
            if self.fsync:
                self.io.fsync(self._f.fileno())
                self.stats["fsyncs"] += 1
        except OSError as e:
            self._handle_write_error(e, boundary)
            return
        self.stats["seals"] += 1
        self.stats["bytes"] += _HEADER.size + len(data)

    def _write_checkpoint(self, payload: Obj, meta: Obj) -> "str | None":
        import contextlib

        with self._mu:
            if self._closed:
                return None
            self.check_writable()
            if self.degraded_errno is not None:
                return None
            new_index = self._seg_index + 1
            doc: Obj = {"t": "checkpoint", "meta": meta, "x": payload}
            if self.last_mark is not None:
                doc["mark"] = self.last_mark
            data = _dumps(doc)
            path = checkpoint_path(self.directory, new_index)
            try:
                with open(path, "wb") as f:
                    f.write(CHECKPOINT_MAGIC)
                    f.write(_HEADER.pack(len(data), zlib.crc32(data) & 0xFFFFFFFF))
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError as e:
                # a half-written checkpoint must never be discoverable —
                # remove it before routing the fault (recovery would
                # otherwise count it bad_checkpoint and fall back anyway)
                with contextlib.suppress(OSError):
                    os.unlink(path)
                self._handle_write_error(e, self._f.tell())
                return None
            # rotate, then prune: the checkpoint at index k covers every
            # record in segments < k.  Seal the finished segment FIRST —
            # a tailer mid-segment follows the seal into the new index
            # without ever needing the checkpoint it already replayed.
            self._seal_locked()
            if self.degraded_errno is not None:
                return None
            self._f.close()
            self._seg_index = new_index
            try:
                self._f = self._open_segment(new_index)
            except OSError as e:
                self._handle_write_error(e, 0)
                return None
            # prune failures (e.g. the fs flipped read-only between the
            # checkpoint fsync and here) are GC misses, not durability
            # faults: stale files linger, recovery still picks the
            # newest valid checkpoint
            with contextlib.suppress(OSError):
                for idx, p in list_segments(self.directory):
                    if idx < new_index:
                        os.unlink(p)
                for idx, p in list_checkpoints(self.directory):
                    if idx < new_index:
                        os.unlink(p)
            self._records_since_checkpoint = 0
            # the checkpoint is the new recovery BASE: later records'
            # meta deltas must diff against ITS full meta, or a field
            # that changed record-lessly and reverted would stay frozen
            # at the checkpoint's intermediate value after a merge
            self._last_meta = meta
            self.stats["compactions"] += 1
            return path

    def close(self) -> None:
        import contextlib

        with self._mu:
            if not self._closed:
                # clean shutdown seals the live segment: a follower can
                # tell "primary exited" from "primary crashed mid-write"
                # (_seal_locked is a no-op once wedged/degraded — the
                # unsealed tail is the honest crash-boundary signal)
                self._seal_locked()
                with contextlib.suppress(OSError, ValueError):
                    self._f.close()
                self._closed = True


# ------------------------------------------------------------------- read


def read_records(path: str, magic: bytes = SEGMENT_MAGIC) -> Iterator[tuple[int, "Obj | None"]]:
    """Yield ``(offset, payload)`` per record; a final ``(offset, None)``
    marks a torn tail (short header/payload, oversized length, bad CRC,
    or undecodable JSON) at ``offset`` — the reader NEVER raises on
    damage, matching recovery's truncate-and-count contract.  A file
    whose leading magic is wrong is treated as torn at offset 0."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(magic))
            if head != magic:
                yield (0, None)
                return
            offset = len(magic)
            while True:
                hdr = f.read(_HEADER.size)
                if not hdr:
                    return  # clean EOF
                if len(hdr) < _HEADER.size:
                    yield (offset, None)
                    return
                length, crc = _HEADER.unpack(hdr)
                if length > _MAX_RECORD:
                    yield (offset, None)
                    return
                data = f.read(length)
                if len(data) < length or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
                    yield (offset, None)
                    return
                try:
                    payload = json.loads(data)
                except ValueError:
                    yield (offset, None)
                    return
                yield (offset, payload)
                offset += _HEADER.size + length
    except OSError:
        yield (0, None)


def read_checkpoint(path: str) -> "Obj | None":
    """The checkpoint's payload, or None when the file is damaged
    (counted by recovery, never raised)."""
    for _off, payload in read_records(path, magic=CHECKPOINT_MAGIC):
        if payload is not None and payload.get("t") == "checkpoint":
            return payload
        return None
    return None


# ------------------------------------------------------------------- env


def _env_flag(raw: "str | None") -> bool:
    return (raw or "").strip().lower() not in ("", "0", "off", "false", "no")


def journal_knobs() -> "Obj | None":
    """The documented ``KSS_JOURNAL_*`` / ``KSS_CHECKPOINT_EVERY`` env
    knobs, validated here so a typo fails loudly at boot
    (docs/environment-variables.md).  Returns None when journaling is
    not enabled (``KSS_JOURNAL_DIR`` unset) — the default, under which
    nothing in this module runs."""
    directory = os.environ.get("KSS_JOURNAL_DIR", "").strip()
    if not directory:
        return None
    every_raw = os.environ.get("KSS_CHECKPOINT_EVERY", "").strip()
    try:
        every = int(every_raw) if every_raw else 0
    except ValueError:
        raise JournalError(
            f"KSS_CHECKPOINT_EVERY must be an integer >= 0, got {every_raw!r}"
        ) from None
    if every < 0:
        raise JournalError(f"KSS_CHECKPOINT_EVERY must be >= 0, got {every}")
    return {
        "directory": directory,
        "fsync": _env_flag(os.environ.get("KSS_JOURNAL_FSYNC")),
        "checkpoint_every": every,
        "on_error": on_error_from_env(),
    }


def on_error_from_env() -> str:
    """The validated ``KSS_JOURNAL_ON_ERROR`` policy — read separately
    from :func:`journal_knobs` because the promotion path builds a
    journal for a directory named by ``KSS_REPLICA_OF``, with
    ``KSS_JOURNAL_DIR`` unset."""
    on_error = os.environ.get("KSS_JOURNAL_ON_ERROR", "").strip().lower() or "wedge"
    if on_error not in ("wedge", "degrade"):
        raise JournalError(
            f"KSS_JOURNAL_ON_ERROR must be 'wedge' or 'degrade', got {on_error!r}"
        )
    return on_error


def journal_from_env() -> "Journal | None":
    """A Journal built from the env knobs, or None when disabled."""
    knobs = journal_knobs()
    if knobs is None:
        return None
    return Journal(
        knobs["directory"],
        fsync=knobs["fsync"],
        checkpoint_every=knobs["checkpoint_every"],
        on_error=knobs["on_error"],
    )
