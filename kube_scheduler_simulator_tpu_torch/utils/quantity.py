"""Kubernetes resource.Quantity parsing.

The reference relies on ``k8s.io/apimachinery``'s Quantity throughout (pod
resource requests, node allocatable).  We parse the same textual forms into
exact integers so the feature encoder and the host-side parity oracle
agree with the Go scheduler:

- plain / decimal numbers: ``2``, ``0.5``, ``1e3``
- binary-SI suffixes: ``Ki Mi Gi Ti Pi Ei``
- decimal-SI suffixes: ``n u m k M G T P E``

``milli_value`` mirrors Quantity.MilliValue (ceil to the nearest milli unit,
used for CPU); ``value`` mirrors Quantity.Value (ceil to the nearest integer,
used for memory/pods/storage).
"""

from __future__ import annotations

import functools
import math
import re
from fractions import Fraction

_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

# A quantity is signedNumber followed by ONE suffix form: a binary-SI or
# decimal-SI suffix, OR a decimal exponent (e/E notation) — never both
# ("1e3Ki" is invalid in apimachinery).
_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:(?:[eE](?P<exp>[+-]?[0-9]+))|(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E))?$"
)


def parse_quantity(q: "str | int | float") -> Fraction:
    """Parse a Kubernetes quantity into an exact Fraction of base units.

    String parses are cached: a cluster snapshot repeats a handful of
    distinct quantity strings across thousands of pods, and the Fraction
    arithmetic dominates encoding time otherwise (Fractions are immutable,
    so sharing the returned object is safe)."""
    if isinstance(q, bool):
        raise ValueError(f"invalid quantity: {q!r}")
    if isinstance(q, int):
        return Fraction(q)
    if isinstance(q, float):
        return Fraction(str(q))
    return _parse_quantity_str(q)


@functools.lru_cache(maxsize=4096)
def _parse_quantity_str(q: str) -> Fraction:
    s = q.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    num = Fraction(m.group("num"))
    if m.group("exp"):
        num *= Fraction(10) ** int(m.group("exp"))
    suffix = m.group("suffix") or ""
    if suffix in _BINARY:
        num *= _BINARY[suffix]
    else:
        num *= _DECIMAL[suffix]
    if m.group("sign") == "-":
        num = -num
    return num


def milli_value(q: "str | int | float") -> int:
    """Quantity.MilliValue: value * 1000, rounded up (away from zero)."""
    if isinstance(q, str):
        return _milli_value_str(q)
    return _ceil(parse_quantity(q) * 1000)


@functools.lru_cache(maxsize=4096)
def _milli_value_str(q: str) -> int:
    return _ceil(_parse_quantity_str(q) * 1000)


def value(q: "str | int | float") -> int:
    """Quantity.Value: rounded up (away from zero) to an integer."""
    if isinstance(q, str):
        return _value_str(q)
    return _ceil(parse_quantity(q))


@functools.lru_cache(maxsize=4096)
def _value_str(q: str) -> int:
    return _ceil(_parse_quantity_str(q))


def _ceil(v: Fraction) -> int:
    if v >= 0:
        return math.ceil(v)
    return -math.ceil(-v)
