"""Deterministic coalescing core: admission queue -> launchable batches.

This module is the service's brain with the event loop removed: it is
synchronous, clock-parameterized (every method takes ``now``), and touches
no arrays — so the coalescing-window, backpressure, and deadline logic is
unit-testable with a hand-rolled clock.  ``repro_torch.serve.service``
drives it from asyncio and owns the actual compute.  A copy of the
reference's ``serve/batcher.py``.

Policy (per bucket):

* the first admission into an empty queue **arms the window**: a launch
  happens when ``max_batch`` co-batchable requests are pending, when the
  window (``max_wait_ms``) expires, or immediately when draining;
* a launch takes the head-of-line request plus FIFO-order requests with the
  *same resolved coefficients* (different coefficients cannot share one
  ``run_batch`` call), up to ``max_batch`` real members and ``max_rounds``
  distinct iteration counts (mixed iters advance in stages);
* expired requests are swept out at launch time and failed with
  ``DeadlineExceeded`` — queue slots are never burned computing results
  nobody will read;
* admission beyond ``queue_cap`` is refused (the service turns that into a
  ``ServiceOverloaded`` with a retry-after hint).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional, Tuple

from repro_torch.serve.config import BucketConfig


@dataclasses.dataclass
class PendingRequest:
    """One admitted request as the batcher sees it: scheduling fields only
    (the request itself is opaque payload until launch)."""
    seq: int
    request: Any
    submitted_at: float
    expires_at: Optional[float]
    #: hashable signature of the *resolved* coefficients — members of one
    #: launch must agree (run_batch takes one coefficient set)
    coeffs_sig: Any
    iters: int
    #: delivery slot (an asyncio.Future in the live service)
    future: Any = None


class BucketState:
    """Pending queue + window state for one bucket.  Synchronous and
    clock-free: callers pass ``now`` everywhere."""

    def __init__(self, cfg: BucketConfig):
        self.cfg = cfg
        self.pending: "deque[PendingRequest]" = deque()
        self.window_start: Optional[float] = None

    def depth(self) -> int:
        return len(self.pending)

    def admit(self, rec: PendingRequest, now: float) -> bool:
        """Queue ``rec``; False when the queue is at ``queue_cap`` (the
        caller rejects with backpressure — nothing was enqueued)."""
        if len(self.pending) >= self.cfg.queue_cap:
            return False
        if not self.pending:
            self.window_start = now
        self.pending.append(rec)
        return True

    def ready_at(self, now: float) -> Optional[float]:
        """Earliest time a launch is due: ``now`` when a full batch is
        already pending, the window expiry otherwise, None when empty."""
        if not self.pending:
            return None
        if self._head_batch_full():
            return now
        return (self.window_start or now) + self.cfg.max_wait_s

    def ready(self, now: float, draining: bool = False) -> bool:
        at = self.ready_at(now)
        if at is None:
            return False
        return draining or at <= now

    def _head_batch_full(self) -> bool:
        """Whether the head-of-line coalescing group already fills
        ``max_batch`` (no point waiting out the window)."""
        head_sig = self.pending[0].coeffs_sig
        n = 0
        for rec in self.pending:
            if rec.coeffs_sig == head_sig:
                n += 1
                if n >= self.cfg.max_batch:
                    return True
        return False

    def take_batch(self, now: float, limit: Optional[int] = None
                   ) -> Tuple[List[PendingRequest], List[PendingRequest]]:
        """Assemble one launch: ``(batch, expired)``.

        Sweeps deadline-expired requests out of the whole queue, then takes
        the head-of-line request plus FIFO requests sharing its coefficient
        signature, capped at ``max_batch`` members and ``max_rounds``
        distinct iteration counts.  Skipped requests keep their order; a
        non-empty remainder re-arms the window at ``now``.

        ``limit`` caps the launch below ``max_batch`` — the circuit
        breaker's degraded mode passes 1 so a flaky backend sees blast
        radius 1 per launch instead of a whole coalesced batch."""
        cap = self.cfg.max_batch if limit is None \
            else min(limit, self.cfg.max_batch)
        expired = [r for r in self.pending
                   if r.expires_at is not None and r.expires_at <= now]
        if expired:
            gone = {r.seq for r in expired}
            self.pending = deque(r for r in self.pending
                                 if r.seq not in gone)
        batch: List[PendingRequest] = []
        if self.pending:
            head_sig = self.pending[0].coeffs_sig
            iters_set = set()
            kept: List[PendingRequest] = []
            for rec in self.pending:
                if len(batch) >= cap:
                    kept.append(rec)
                    continue
                if rec.coeffs_sig != head_sig:
                    kept.append(rec)
                    continue
                if (rec.iters not in iters_set
                        and len(iters_set) >= self.cfg.max_rounds):
                    kept.append(rec)
                    continue
                iters_set.add(rec.iters)
                batch.append(rec)
            self.pending = deque(kept)
        self.window_start = now if self.pending else None
        return batch, expired
