"""Live journal shipping: tail a primary's write-ahead log as it grows.

A :class:`JournalTailer` incrementally follows the segment files of a
LIVE ``KSS_JOURNAL_DIR`` — one the primary process is still appending
to — across rotation and compaction.  It is the read side of the
journal re-purposed as a replication transport, and it differs from
boot-time recovery (:mod:`state.recovery`) in exactly one hard rule:

    **it never truncates the primary's files.**

Recovery may truncate a torn tail in place because it owns the
directory (the writer is dead).  A tailer shares the directory with a
live writer, so every damage verdict must be made read-only — and
deterministically, which the journal's write side guarantees:

- Frames are published with ONE buffered write + flush (header +
  payload together), so a reader always observes a strict PREFIX of
  the logical record stream.  A SHORT frame at the tail of the newest
  segment is therefore a record mid-write: **wait and re-poll**.
- A FULL-LENGTH frame whose CRC or JSON fails, or an impossible length
  field, can only be real damage: **torn** — counted, never skipped
  silently, never "waited out".
- Rotation seals the finished segment (``{"t": "seal"}`` marker,
  state/journal.py) before opening index+1, so a consumed seal means
  "segment complete, continue at the next index".  A segment
  superseded by a newer segment/checkpoint WITHOUT a seal marks a
  crash boundary: its clean end-of-file is the primary's SIGKILL at a
  record boundary, and any leftover partial tail is the torn write the
  recovering primary will truncate.

Compaction can prune the segment a slow tailer is parked on; that
surfaces as :class:`SegmentPruned` and the applier REBASES from the
newest checkpoint (replication/apply.py) — the replica's watchers then
410-relist exactly like a primary's watchers across a checkpoint.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import zlib
from typing import Any

from kube_scheduler_simulator_tpu_torch.state import journal as J
from kube_scheduler_simulator_tpu_torch.state.journal import _HEADER, _MAX_RECORD, classify_errno

Obj = dict[str, Any]


class SegmentPruned(RuntimeError):
    """The segment the tailer was reading was compacted away before it
    finished — the follower must rebase from the newest checkpoint."""


class JournalTailer:
    """Incremental, read-only follower of one journal directory.

    ``poll()`` returns every COMPLETE record payload that became
    readable since the last call, in order, crossing sealed segments
    and crash boundaries; checkpoint documents are injected into the
    stream at the rotation points they belong to (the applier uses
    them as fresh meta bases).  ``pending_records()`` counts complete
    frames not yet consumed — the replication-lag gauge's numerator.
    ``finalize()`` is the promotion step: with the primary known dead,
    drain what remains and classify any outstanding partial tail as
    torn (counted — never truncated; the directory may still be shared
    with a recovering primary).
    """

    def __init__(self, directory: str, start_index: int = 0):
        self.directory = directory
        # segments below this are covered by the bootstrap checkpoint
        self._min_index = int(start_index)
        self._seg: "int | None" = None  # current segment index
        self._offset = 0  # next unread byte in the current segment
        # (seg, offset) already counted torn — a wedged live tail must
        # not re-count on every poll
        self._torn_key: "tuple[int, int] | None" = None
        self.finalized = False
        # injectable open() — the resilience smoke/chaos harness lands
        # EACCES/EIO on an exact poll without needing a non-root euid
        self.io_open: Any = open
        self.stats: dict[str, int] = {
            "records": 0,
            "seals": 0,
            "torn_records": 0,
            "segments_crossed": 0,
            "checkpoints_crossed": 0,
            "read_errors": 0,
        }
        # read-side I/O faults by errno label — ENOENT is never here
        # (an absent file is the "not created yet" wait state, not an
        # error); EACCES/EIO/… are counted so a misconfigured
        # KSS_REPLICA_OF surfaces instead of silently polling forever
        self.read_errors_by_errno: dict[str, int] = {}

    # ------------------------------------------------------------ position

    def position(self) -> "tuple[int | None, int]":
        return (self._seg, self._offset)

    def rebase_to(self, seg_index: int) -> None:
        """Reposition after the applier loaded a checkpoint at
        ``seg_index`` (bootstrap or a post-prune rebase)."""
        self._min_index = int(seg_index)
        self._seg = int(seg_index)
        self._offset = 0
        self._torn_key = None

    def _note_read_error(self, e: OSError) -> None:
        """Count a non-ENOENT read-side I/O fault (EACCES, EIO, ENOTDIR
        — the satellite bug: a bare ``except OSError`` classified a
        permission-denied primary dir identically to "not created yet",
        so a misconfigured ``KSS_REPLICA_OF`` polled forever in
        silence).  Surfaced as ``replication_read_errors_total{errno}``;
        the applier backs off through its RetryPolicy while these
        accumulate."""
        label = classify_errno(e)
        self.stats["read_errors"] += 1
        self.read_errors_by_errno[label] = self.read_errors_by_errno.get(label, 0) + 1

    def _list(self, lister) -> list[tuple[int, str]]:
        """Directory listing with the wait-vs-error split: ENOENT means
        "not created yet" (wait, uncounted); anything else is a counted
        read error and reads as empty until the fault clears."""
        try:
            return lister(self.directory)
        except OSError as e:
            if e.errno == _errno.ENOENT:
                return []
            self._note_read_error(e)
            return []

    def _discover(self) -> "int | None":
        for idx, _path in self._list(J.list_segments):
            if idx >= self._min_index:
                return idx
        return None

    def _newer_exists(self, idx: int) -> bool:
        """Any segment or checkpoint with index > ``idx`` — the writer
        has moved past ``idx``, so its tail can no longer grow."""
        return any(i > idx for i, _ in self._list(J.list_segments)) or any(
            i > idx for i, _ in self._list(J.list_checkpoints)
        )

    # ------------------------------------------------------------- reading

    def _read_frames(self, path: str, offset: int) -> "tuple[list[Obj], int, str, int]":
        """One read-only pass over a segment from ``offset``.  Returns
        ``(payloads, new_offset, state, leftover)`` with state one of
        ``open`` (end of complete data; ``leftover`` bytes of a frame
        may be mid-write), ``sealed`` (seal consumed — segment
        complete), ``torn`` (full frame failed CRC/JSON or impossible
        length — real damage at ``new_offset``), ``missing`` (file
        absent — ENOENT only), ``error`` (any other I/O fault — counted
        via ``_note_read_error``; the caller waits and the applier
        backs off)."""
        frames: list[Obj] = []
        try:
            with self.io_open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if offset == 0:
                    if size < len(J.SEGMENT_MAGIC):
                        return frames, 0, "open", size
                    if f.read(len(J.SEGMENT_MAGIC)) != J.SEGMENT_MAGIC:
                        return frames, 0, "torn", size
                    offset = len(J.SEGMENT_MAGIC)
                f.seek(offset)
                while True:
                    hdr = f.read(_HEADER.size)
                    if len(hdr) < _HEADER.size:
                        return frames, offset, "open", len(hdr)
                    length, crc = _HEADER.unpack(hdr)
                    if length > _MAX_RECORD:
                        # a full header is a true frame prefix (single-
                        # write publish), so a garbage length is damage,
                        # not a mid-write transient
                        return frames, offset, "torn", size - offset
                    data = f.read(length)
                    if len(data) < length:
                        return frames, offset, "open", _HEADER.size + len(data)
                    if (zlib.crc32(data) & 0xFFFFFFFF) != crc or not data:
                        return frames, offset, "torn", size - offset
                    try:
                        payload = json.loads(data)
                    except ValueError:
                        return frames, offset, "torn", size - offset
                    offset += _HEADER.size + length
                    if payload.get("t") == J.SEAL_TYPE:
                        return frames, offset, "sealed", 0
                    frames.append(payload)
        except OSError as e:
            if e.errno == _errno.ENOENT:
                return frames, offset, "missing", 0
            self._note_read_error(e)
            return frames, offset, "error", 0

    def _advance(self) -> None:
        """Move to the next segment index (rotation and recovery epochs
        both open exactly index+1), injecting the matching checkpoint
        into the stream if one was written at the boundary."""
        assert self._seg is not None
        self._seg += 1
        self._offset = 0
        self._torn_key = None
        self.stats["segments_crossed"] += 1

    def _checkpoint_at(self, idx: int) -> "Obj | None":
        path = J.checkpoint_path(self.directory, idx)
        if not os.path.exists(path):
            return None
        payload = J.read_checkpoint(path)
        if payload is not None:
            self.stats["checkpoints_crossed"] += 1
        return payload

    def poll(self) -> list[Obj]:
        """Consume every record currently readable; returns payloads in
        order (seals consumed silently, rotation checkpoints injected
        as ``{"t": "checkpoint", ...}`` documents at their boundary).
        Raises :class:`SegmentPruned` when compaction deleted the
        segment under the tailer."""
        out: list[Obj] = []
        if self.finalized:
            return out
        while True:
            if self._seg is None:
                self._seg = self._discover()
                self._offset = 0
                if self._seg is None:
                    return out  # nothing journaled yet: wait
            path = J.segment_path(self.directory, self._seg)
            frames, new_off, state, leftover = self._read_frames(path, self._offset)
            out.extend(frames)
            self.stats["records"] += len(frames)
            self._offset = new_off
            if state == "sealed":
                self.stats["seals"] += 1
                self._advance()
                ckpt = self._checkpoint_at(self._seg)
                if ckpt is not None:
                    out.append(ckpt)
                continue
            if state == "error":
                # transient (or persistent) I/O fault on the primary's
                # files: counted above; hold position and let the
                # applier's RetryPolicy pace the re-polls
                return out
            if state == "missing":
                if self._offset == 0 and self._newer_exists(self._seg - 1):
                    # compaction pruned it before we consumed it (or we
                    # were parked mid-segment when it vanished): rebase
                    raise SegmentPruned(
                        f"segment {self._seg} pruned under the tailer "
                        f"(rebase from the newest checkpoint)"
                    )
                if self._offset > 0:
                    raise SegmentPruned(
                        f"segment {self._seg} vanished mid-read at offset {self._offset}"
                    )
                return out  # directory/segment not created yet: wait
            if state == "open":
                if not self._newer_exists(self._seg):
                    return out  # the LIVE tail: wait and re-poll
                # the writer moved past this segment without sealing it:
                # a crash boundary.  A clean end-of-file is the SIGKILL-
                # at-a-record-boundary shape; leftover partial bytes are
                # the torn write the recovering primary truncates — we
                # count them (ONCE) and step over, never truncating.
                if leftover > 0 and self._torn_key != (self._seg, self._offset):
                    self._torn_key = (self._seg, self._offset)
                    self.stats["torn_records"] += 1
                self._advance()
                ckpt = self._checkpoint_at(self._seg)
                if ckpt is not None:
                    out.append(ckpt)
                continue
            # state == "torn": real damage (full frame, bad bytes)
            if self._torn_key != (self._seg, self._offset):
                self._torn_key = (self._seg, self._offset)
                self.stats["torn_records"] += 1
            if self._newer_exists(self._seg):
                # superseded segment: skip the damage, continue at the
                # next index (recovery will have truncated exactly here)
                self._advance()
                ckpt = self._checkpoint_at(self._seg)
                if ckpt is not None:
                    out.append(ckpt)
                continue
            # damage on the LIVE newest segment: nothing readable past
            # it until the primary rotates or a promotion finalizes
            return out

    def pending_records(self) -> int:
        """Complete frames readable but not yet consumed — a read-only
        count from the current position (the lag gauge's numerator).
        0 when fully caught up with the durable stream."""
        if self.finalized or self._seg is None:
            return 0
        n = 0
        seg, offset = self._seg, self._offset
        while True:
            frames, _off, state, _left = self._read_frames(
                J.segment_path(self.directory, seg), offset
            )
            n += len(frames)
            if state == "sealed" or (state in ("open", "torn") and self._newer_exists(seg)):
                seg += 1
                offset = 0
                continue
            return n

    def finalize(self) -> list[Obj]:
        """Promotion-time drain: the primary is known dead, so consume
        everything readable and classify any outstanding partial tail
        as torn (counted; NEVER truncated — the directory may be shared
        with a primary that comes back and recovers it)."""
        out = self.poll()
        if self._seg is not None:
            path = J.segment_path(self.directory, self._seg)
            _frames, _off, state, leftover = self._read_frames(path, self._offset)
            if state == "open" and leftover > 0 and self._torn_key != (self._seg, self._offset):
                self._torn_key = (self._seg, self._offset)
                self.stats["torn_records"] += 1
        self.finalized = True
        return out
