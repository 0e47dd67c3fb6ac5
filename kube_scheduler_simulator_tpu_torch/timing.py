"""Device time of a short kernel on the card, for the port's timing scripts
(``time_preempt.py``, ``time_scan.py``, ``time_gang.py``) and
``chip_smoke.py``."""

from __future__ import annotations

import time

import torch

# device_ms: the card sleeps this long (about 50 ms at the H100's 1.98 GHz
# boost clock; at least SLEEP_MS at any clock it runs) while the host
# enqueues the timed launches
SLEEP_CYCLES, SLEEP_MS = 100_000_000, 40.0


def device_ms(fn, reps: int, warmup: int = 3) -> "tuple[float, float, object]":
    """(ms a launch on the card, ms a call on the host, the last result) of
    a short kernel: the card first sleeps while the host enqueues ``reps``
    calls behind it, so the CUDA events around them time the launches back
    to back, not the host's call overhead between them.  Raises when the
    host took longer to enqueue them than the card slept."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    s.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn()
    host = time.perf_counter() - t0
    e.record()
    torch.cuda.synchronize()
    if s.elapsed_time(e) <= 0 or host * 1e3 > SLEEP_MS:
        raise RuntimeError(f"device_ms: the host took {host * 1e3:.2f} ms to enqueue {reps} calls")
    return s.elapsed_time(e) / reps, host * 1e3 / reps, res
