"""Scheduling-framework contracts the batch path reads: Status and scores.

Semantics follow the v1.26 framework the reference pins:

- A nil/None status means Success.
- ``Status.message()`` joins reasons with ", " — this exact string is what
  lands in the filter annotations.
- Scores are int64 in [MIN_NODE_SCORE, MAX_NODE_SCORE].
"""

from __future__ import annotations

import enum
from typing import Sequence

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0


class Code(enum.IntEnum):
    """framework.Code (upstream framework/interface.go)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


class Status:
    """framework.Status: a code plus human-readable reasons."""

    __slots__ = ("code", "reasons", "plugin")

    def __init__(self, code: Code = Code.SUCCESS, reasons: "Sequence[str] | None" = None, plugin: str = ""):
        self.code = code
        self.reasons = list(reasons or [])
        self.plugin = plugin

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE, reasons)

    @staticmethod
    def unresolvable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, reasons)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def message(self) -> str:
        return ", ".join(self.reasons)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Status({self.code.name}, {self.message()!r})"
