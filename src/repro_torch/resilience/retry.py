"""Retry budgets and the per-bucket circuit breaker (pure Python, as in
the reference's ``resilience/retry.py``).

:class:`RetryPolicy` is the capped-exponential-backoff budget a failing
launch spends before it is declared
:class:`~repro_torch.resilience.health.LaunchFailed`.
:class:`CircuitBreaker` is the per-bucket meltdown guard above it:
consecutive launch failures degrade the bucket from coalesced
launches to per-request launches (blast radius 1), then to rejecting
admissions with a retry-after — the service sheds load instead of burning
its retry budget on every queued request while the backend is down.

Breaker states::

    closed ──(fail_threshold consecutive launch failures)──► degraded
    degraded ──(recovery_successes consecutive successes)──► closed
    degraded ──(open_threshold further consecutive failures)──► open
    open ──(open_cooldown_s elapsed)──► degraded   (probe traffic again)

Only infrastructure failures (:class:`LaunchFailed` after retries) move the
breaker; a :class:`NumericalFault` is the *request's* fault, not the
backend's, and must never trip capacity for healthy neighbors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: attempt ``k`` (1-based) sleeps
    ``min(base_backoff_s * 2**(k-1), max_backoff_s)`` before retrying,
    up to ``max_attempts`` total attempts."""
    max_attempts: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")

    @classmethod
    def make(cls, spec) -> "RetryPolicy":
        if isinstance(spec, cls):
            return spec
        if spec is None:
            return cls()
        if spec is False:
            return cls(max_attempts=1)      # no retries
        if isinstance(spec, dict):
            return cls(**spec)
        raise ValueError(f"retry spec must be a RetryPolicy, dict, False or "
                         f"None, got {type(spec).__name__}")

    def backoff_s(self, attempt: int) -> float:
        """Sleep before the retry that follows failed attempt ``attempt``."""
        return min(self.base_backoff_s * (2 ** max(0, attempt - 1)),
                   self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Thresholds of the per-bucket circuit breaker (see module doc)."""
    fail_threshold: int = 3        #: closed -> degraded after this many
    open_threshold: int = 3        #: degraded -> open after this many more
    recovery_successes: int = 2    #: degraded -> closed after this many
    open_cooldown_s: float = 5.0   #: open -> degraded (probe) after this

    def __post_init__(self):
        for f in ("fail_threshold", "open_threshold", "recovery_successes"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.open_cooldown_s <= 0:
            raise ValueError(f"open_cooldown_s must be > 0, "
                             f"got {self.open_cooldown_s}")

    @classmethod
    def make(cls, spec) -> Optional["BreakerConfig"]:
        """None/True -> defaults; False -> disabled (returns None)."""
        if isinstance(spec, cls):
            return spec
        if spec is None or spec is True:
            return cls()
        if spec is False:
            return None
        if isinstance(spec, dict):
            return cls(**spec)
        raise ValueError(f"breaker spec must be a BreakerConfig, dict or "
                         f"bool, got {type(spec).__name__}")


class CircuitBreaker:
    """Mutable per-bucket breaker state (single-threaded: the service only
    touches it from the event loop)."""

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.state = "closed"
        self._consecutive_failures = 0
        self._consecutive_successes = 0
        self._opened_at: Optional[float] = None
        #: lifetime transition log (state, at) — snapshot-able history
        self.transitions: list = []

    def _to(self, state: str, now: float) -> None:
        if state != self.state:
            self.state = state
            self.transitions.append((state, now))

    # --- events --------------------------------------------------------------
    def on_failure(self, now: float) -> None:
        """One launch spent its whole retry budget (infrastructure failure —
        numerical faults must NOT be reported here)."""
        self._consecutive_successes = 0
        self._consecutive_failures += 1
        if self.state == "closed":
            if self._consecutive_failures >= self.cfg.fail_threshold:
                self._consecutive_failures = 0
                self._to("degraded", now)
        elif self.state == "degraded":
            if self._consecutive_failures >= self.cfg.open_threshold:
                self._consecutive_failures = 0
                self._opened_at = now
                self._to("open", now)

    def on_success(self, now: float) -> None:
        self._consecutive_failures = 0
        self._consecutive_successes += 1
        if self.state == "degraded" \
                and self._consecutive_successes >= self.cfg.recovery_successes:
            self._consecutive_successes = 0
            self._to("closed", now)

    # --- queries -------------------------------------------------------------
    def mode(self, now: float) -> str:
        """Current state, advancing ``open -> degraded`` when the cooldown
        has elapsed (the probe re-admission)."""
        if self.state == "open" and self._opened_at is not None \
                and now - self._opened_at >= self.cfg.open_cooldown_s:
            self._opened_at = None
            self._to("degraded", now)
        return self.state

    def admits(self, now: float) -> bool:
        return self.mode(now) != "open"

    def retry_after_s(self, now: float) -> float:
        """How long an open breaker asks callers to stay away."""
        if self.state != "open" or self._opened_at is None:
            return 0.0
        return max(0.0, self.cfg.open_cooldown_s - (now - self._opened_at))
