"""KSS-ENV bad fixture 2: undocumented reads through every read shape."""

import os


def _env_int(name, default):
    raw = os.environ.get(name)
    return int(raw) if raw else default


def knobs():
    a = _env_int("KSS_FIXTURE_HELPER_READ", 3)  # expect-finding
    b = os.getenv("AUTOSCALE_FIXTURE_GETENV")  # expect-finding
    c = os.environ["KSS_FIXTURE_SUBSCRIPT"]  # expect-finding
    return a, b, c
