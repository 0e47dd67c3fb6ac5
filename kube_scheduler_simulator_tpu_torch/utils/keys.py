"""The canonical ns/name pod key used across the scheduler runtime
(service, queue, extender, reflector) — one definition so key semantics
can never diverge between the components feeding each other."""

from __future__ import annotations

from typing import Any, Mapping


def pod_key(pod: Mapping[str, Any]) -> str:
    return f"{pod['metadata'].get('namespace', 'default')}/{pod['metadata']['name']}"
