"""Serving observability: counters, latency percentiles, batch-fill, JSON
(the reference's ``serve/metrics.py``).

``ServiceMetrics`` is updated only from the event-loop thread (admission
and delivery both run there), so it needs no locking.  The reference's
snapshot folds in XLA's executable-cache statistics; the port has no
executable cache, so its snapshot has no ``exec_cache`` key.
"""
from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional


def percentile(samples, q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) of an unsorted sample list."""
    if not samples:
        return None
    s = sorted(samples)
    if len(s) == 1:
        return float(s[0])
    rank = max(0, min(len(s) - 1, round(q / 100.0 * (len(s) - 1))))
    return float(s[rank])


#: rejection kinds — every non-served request lands in exactly one counter,
#: which is what "never silently dropped" means operationally.  "breaker"
#: is the circuit breaker shedding load while a bucket's backend is down.
REJECT_KINDS = ("overload", "deadline", "no_bucket", "closed", "breaker")

#: failure kinds — requests that were *admitted and launched* but could not
#: be served: the launch kept erroring after its retry budget
#: ("launch_failed") or the result failed the numerical health check
#: ("numerical_fault").  Disjoint from both ``completed`` and ``rejected``,
#: so conservation reads
#: ``submitted == completed + rejected + failed + in_flight``.
FAIL_KINDS = ("launch_failed", "numerical_fault")


class ServiceMetrics:
    """Mutable service telemetry; ``snapshot()`` renders it immutably."""

    def __init__(self, clock=time.monotonic, window: int = 4096):
        self._clock = clock
        self._window = window
        self.reset()

    def reset(self) -> None:
        """Zero every counter and sample window (benchmark warm-up passes
        reset before the measured interval; pre-warm timings survive via
        :meth:`note_prewarm` being re-recorded at boot only)."""
        self.started_at: Optional[float] = None
        self.submitted = 0
        self.completed = 0
        self.rejected: Dict[str, int] = {k: 0 for k in REJECT_KINDS}
        self.failed: Dict[str, int] = {k: 0 for k in FAIL_KINDS}
        #: requests failed by the *per-member* health check while their
        #: co-batched neighbors were delivered (a subset of
        #: ``failed["numerical_fault"]`` — solo numerical faults count in
        #: the kind counter but not here)
        self.quarantined = 0
        #: launch retries spent (attempts beyond the first, incl. bisection
        #: sub-launches after a coalesced launch failed)
        self.retries = 0
        #: latest circuit-breaker state per bucket ("closed" when none)
        self.breaker: Dict[str, str] = {}
        self.batches = 0
        self.rounds = 0
        self.busy_s = 0.0
        #: delivered cell-updates (sum over completed requests of
        #: prod(shape) * iters) — the serving-throughput numerator
        self.cells = 0
        self.prewarm_s: Dict[str, float] = {}
        self.queue_depth: Dict[str, int] = {}
        self._latency_s = deque(maxlen=self._window)
        self._fills = deque(maxlen=self._window)
        self._batch_sizes = deque(maxlen=self._window)

    # --- recording (event-loop thread only) ---------------------------------
    def note_started(self) -> None:
        self.started_at = self._clock()

    def note_submitted(self) -> None:
        self.submitted += 1

    def note_rejected(self, kind: str) -> None:
        self.rejected[kind] += 1

    def note_failed(self, kind: str, quarantined: bool = False) -> None:
        """One admitted-and-launched request failed (see ``FAIL_KINDS``);
        ``quarantined=True`` when its healthy co-batched neighbors were
        still delivered."""
        self.failed[kind] += 1
        if quarantined:
            self.quarantined += 1

    def note_retry(self, n: int = 1) -> None:
        self.retries += n

    def note_breaker(self, bucket: str, mode: str) -> None:
        self.breaker[bucket] = mode

    def note_depth(self, bucket: str, depth: int) -> None:
        self.queue_depth[bucket] = depth

    def note_prewarm(self, bucket: str, seconds: float) -> None:
        self.prewarm_s[bucket] = seconds

    def note_batch(self, real: int, padded: int, rounds: int,
                   exec_s: float) -> None:
        self.batches += 1
        self.rounds += rounds
        self.busy_s += exec_s
        self._fills.append(real / padded)
        self._batch_sizes.append(real)

    def note_completed(self, latency_s: float, cell_updates: int) -> None:
        self.completed += 1
        self.cells += cell_updates
        self._latency_s.append(latency_s)

    # --- reporting ----------------------------------------------------------
    @property
    def batch_fill(self) -> Optional[float]:
        if not self._fills:
            return None
        return sum(self._fills) / len(self._fills)

    def snapshot(self) -> dict:
        """One JSON-serializable document of everything above."""
        now = self._clock()
        lat = list(self._latency_s)
        wall = (now - self.started_at) if self.started_at is not None else None
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": dict(self.rejected),
            "rejected_total": sum(self.rejected.values()),
            "failed": dict(self.failed),
            "failed_total": sum(self.failed.values()),
            "quarantined": self.quarantined,
            "retries": self.retries,
            "breaker": dict(self.breaker),
            # conservation: submitted == completed + rejected + failed +
            # in_flight — asserted by the test suite after every drain, so
            # a request that fell through a crack shows up as a nonzero
            # in_flight on an idle service
            "in_flight": (self.submitted - self.completed
                          - sum(self.rejected.values())
                          - sum(self.failed.values())),
            "batches": self.batches,
            "rounds": self.rounds,
            "batch_fill": self.batch_fill,
            "batch_size_mean": (sum(self._batch_sizes)
                                / len(self._batch_sizes)
                                if self._batch_sizes else None),
            "latency_ms": {
                "p50": _ms(percentile(lat, 50)),
                "p90": _ms(percentile(lat, 90)),
                "p99": _ms(percentile(lat, 99)),
                "max": _ms(max(lat)) if lat else None,
                "n": len(lat),
            },
            "cells": self.cells,
            "busy_s": self.busy_s,
            "wall_s": wall,
            "cells_s_busy": self.cells / self.busy_s if self.busy_s else None,
            "cells_s_wall": (self.cells / wall if wall else None),
            "queue_depth": dict(self.queue_depth),
            "prewarm_s": dict(self.prewarm_s),
        }

    def write_json(self, path) -> Path:
        """Snapshot to a JSON file (parents created); returns the path."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.snapshot(), indent=1, sort_keys=True)
                     + "\n")
        return p


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds * 1e3
