"""SimClock: the one deterministic time source for simulated runs.

Every byte-reproducible harness in this repo needs the same two pins:

- the ``ClusterStore`` clock (creationTimestamps — ``PrioritySort``
  tie-breaks on them, so a wall-clock stamp landing across a second
  boundary mid-build can flip round order and diverge annotation bytes),
  and
- the ``SchedulerService`` clock (scheduling-queue backoff and every
  framework's Permit deadlines — gang ``scheduleTimeoutSeconds`` expiry
  must replay on simulated time).

Before this module each suite hand-rolled the pair (``clock=lambda:
1700000000.0`` store pins + ``ScenarioClock`` service wiring).  SimClock
is that promotion: one instance can serve both roles, or two instances
can pin them independently.  It never auto-advances — the number of
clock *reads* differs between the batch and sequential paths, so a
read-advancing clock would itself be a divergence source; time moves
only when the code running the simulation calls :meth:`advance` (the
scenario engine advances per MajorStep delta; the fuzz runner per feed
tick).

``ScenarioClock`` (scenario/engine.py) is the historical name for the
service-side role and is now a subclass of this.
"""

from __future__ import annotations


class SimClock:
    """Deterministic callable time source starting at ``start`` seconds.

    Usable anywhere a ``Callable[[], float]`` clock is accepted:
    ``ClusterStore(clock=SimClock(0.0))``,
    ``SchedulerService(..., clock=SimClock())``.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        """Move simulated time forward by ``dt`` seconds (negative ``dt``
        is rejected: simulated time, like the monotonic clock it stands
        in for, never runs backwards)."""
        dt = float(dt)
        if dt < 0:
            raise ValueError(f"SimClock cannot run backwards (dt={dt})")
        self.now += dt
        return self.now
