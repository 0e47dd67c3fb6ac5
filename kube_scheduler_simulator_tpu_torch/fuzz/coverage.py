"""Coverage buckets: structural diversity for the scenario generator.

Uniform random sampling over feature combinations wastes most of a
scenario budget re-testing the combinations it happened to hit first.
The generator instead tracks a *coverage bucket* per scenario — the
frozen set of subsystems/gates the scenario composes — and, when asked
for the next scenario's features, proposes a handful of candidate
subsets and picks the one whose bucket has been exercised least.  This
is diversity-seeking sampling in the spirit of the GFlowNet scheduling
line (PAPERS.md, arxiv 2302.05446): sample structures proportionally to
how *novel* they are rather than uniformly, so a bounded budget spreads
over the composition lattice instead of piling onto its mode.

Buckets are over the five counted subsystems (the composition
bar): ``gang``, ``preemption``, ``autoscale``, ``churn``, ``retune``.
Sub-flavors (taints, PDB flips, topology spread) ride inside those and
vary with the scenario seed, not the bucket key.

The lattice also carries an EXECUTION-MODE extension: the
``mesh-stream`` tag marks a scenario driven through the fused
sharded-streaming path (the reference's ``shard-stream-vs-serial``
comparison; the port's runner refuses it), so the coverage summary
distinguishes "this composition ran" from "this composition ran through
the stream × mesh fusion".  Execution tags are noted via
:meth:`CoverageMap.note_exec`; they never enter the generator's feature
sampling (they describe how a scenario was DRIVEN, not what it
composes).
"""

from __future__ import annotations

import itertools
import random

# the composable subsystems — every generated scenario picks >= MIN_COMPOSE
FEATURES: tuple[str, ...] = ("gang", "preemption", "autoscale", "churn", "retune")
MIN_COMPOSE = 3

# execution-mode bucket tags (never sampled as scenario features): the
# stream × mesh fusion leg marks its scenarios' buckets with this
MESH_STREAM = "mesh-stream"


def all_buckets(min_size: int = MIN_COMPOSE) -> list[frozenset[str]]:
    """Every feature subset of size >= ``min_size``, in a stable order."""
    out: list[frozenset[str]] = []
    for r in range(min_size, len(FEATURES) + 1):
        for combo in itertools.combinations(FEATURES, r):
            out.append(frozenset(combo))
    return out


class CoverageMap:
    """Counts scenarios per coverage bucket and proposes the next one.

    Deterministic: the choice is a pure function of the rng state and
    the counts accumulated so far, so the same seed + the same scenario
    sequence always picks the same buckets (the smoke's fixed seed list
    depends on this).
    """

    def __init__(self) -> None:
        self.counts: dict[frozenset[str], int] = {}

    def note(self, features: "frozenset[str] | set[str] | list[str]") -> None:
        key = frozenset(features)
        self.counts[key] = self.counts.get(key, 0) + 1

    def note_exec(self, features: "frozenset[str] | set[str] | list[str]", mode: str = MESH_STREAM) -> None:
        """Record an execution-mode bucket: the scenario's feature set
        tagged with how it was driven (e.g. ``mesh-stream`` for the
        sharded + streamed differential leg).  Kept apart from
        :meth:`note` so the generator's least-covered sampling over the
        plain feature lattice is unaffected."""
        self.note(frozenset(features) | {mode})

    def choose_features(self, rng: random.Random, candidates: int = 6) -> frozenset[str]:
        """Draw ``candidates`` random feature subsets (size >= MIN_COMPOSE)
        and return the least-covered one; ties break toward the smaller
        bucket first (cheaper scenarios), then the draw order — all
        deterministic under ``rng``."""
        best: "frozenset[str] | None" = None
        best_rank: "tuple[int, int, int] | None" = None
        for i in range(max(candidates, 1)):
            size = rng.randint(MIN_COMPOSE, len(FEATURES))
            combo = frozenset(rng.sample(FEATURES, size))
            rank = (self.counts.get(combo, 0), len(combo), i)
            if best_rank is None or rank < best_rank:
                best, best_rank = combo, rank
        assert best is not None
        return best

    def summary(self) -> dict[str, int]:
        """Bucket -> count with stable "+".join(sorted(...)) keys (the
        smoke's end-of-run histogram)."""
        return {
            "+".join(sorted(bucket)): n
            for bucket, n in sorted(self.counts.items(), key=lambda kv: sorted(kv[0]))
        }
