"""Deterministic, seedable fault injection — every failure mode testable.

A copy of the reference's ``resilience/faults.py`` (numpy only), with the
poisoning of :func:`corrupt_point` done on tensors or numpy arrays.

The production code is threaded with named **injection points** at its hot
seams (backend execute, the serving launch path, cache reads, the
distributed exchange, checkpoint save/restore).  Each seam registers its
point at import time (:func:`register_point`) and calls :func:`fault_point`
(control seams) or :func:`corrupt_point` (result-producing seams) on every
pass.  With no plan installed both are a single global ``None`` check —
the resilience layer costs nothing when it is off.

A :class:`FaultPlan` is a set of :class:`FaultSpec` triggers::

    plan = FaultPlan([
        # the 2nd coalesced launch raises (transient infra failure)
        FaultSpec("serve.launch", nth=2),
        # every backend batch result gets member 1 poisoned with NaN
        FaultSpec("backend.execute_batch.result", action="nan", member=1,
                  max_fires=None),
        # 10% of schedule-cache reads fail like a flaky filesystem
        FaultSpec("schedule_cache.get", p=0.1, exc=OSError),
    ], seed=7)
    with plan.active():
        ...

Determinism: ``nth`` counts calls per point (1-based); probabilistic
triggers draw from a per-(plan seed, point, spec index) ``numpy``
``default_rng`` stream — the same plan against the same call sequence fires
the same faults, every run, on every machine.  ``action="kill"`` sends the
process ``SIGKILL`` (crash-testing checkpoint resume); ``match`` narrows a
spec to calls whose context satisfies a predicate (e.g. "only launches
containing request #3" — how the quarantine-bisection tests pin the poison
member deterministically).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """Default exception an injection raises (``FaultSpec.exc`` overrides —
    e.g. ``OSError`` to model a real filesystem failure at a cache seam)."""


#: every injection point the production code declares, name -> doc.  The
#: reference's chaos matrix (tests/test_resilience.py) iterates its
#: registry, so a new seam is covered the day it registers.
_REGISTRY: Dict[str, str] = {}
_lock = threading.Lock()


def register_point(name: str, doc: str = "") -> str:
    """Declare an injection point (idempotent; returns ``name`` so seams can
    do ``POINT = register_point(...)``)."""
    with _lock:
        _REGISTRY.setdefault(name, doc)
    return name


def registered_points() -> Dict[str, str]:
    """Snapshot of every declared injection point (name -> doc)."""
    with _lock:
        return dict(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One trigger: *where* (``point``), *when* (``nth`` / ``p`` /
    ``match``), *what* (``action``), and *how often* (``max_fires``).

    Parameters
    ----------
    point:
        Injection-point name (see :func:`registered_points`).
    action:
        ``"raise"`` (default) raises ``exc``; ``"nan"`` poisons the value a
        :func:`corrupt_point` seam passes through (no-op at plain
        :func:`fault_point` seams); ``"kill"`` sends the process
        ``SIGKILL`` — no cleanup, no atexit: exactly what a crashed host
        looks like to the checkpoint substrate.
    nth:
        Fire on the Nth call at this point (1-based, counted per plan
        installation).  ``None`` = every call is eligible.
    p:
        Per-call firing probability, drawn from a deterministic per-spec
        stream seeded by (plan seed, point, spec index).
    max_fires:
        Stop firing after this many firings (``None`` = unlimited).
        Defaults to 1 for ``nth``/plain specs — a *transient* fault a retry
        survives — and must be explicit for always-on faults.
    exc:
        Exception type ``"raise"`` throws (default :class:`InjectedFault`).
        Pick the type a real failure would produce (``OSError`` at
        filesystem seams) to exercise the same handler.
    member:
        For ``"nan"`` at a batched result seam: which batch member to
        poison (leading-axis index).  ``None`` poisons element 0 of an
        unbatched value.
    match:
        Optional predicate on the call's context dict (seams pass one where
        it is meaningful, e.g. the serving launch passes request seqs) —
        the spec fires only when ``match(ctx)`` is truthy.
    """
    point: str
    action: str = "raise"
    nth: Optional[int] = None
    p: Optional[float] = None
    max_fires: Optional[int] = 1
    exc: type = InjectedFault
    member: Optional[int] = None
    match: Optional[Callable[[dict], bool]] = None

    def __post_init__(self):
        if self.action not in ("raise", "nan", "kill"):
            raise ValueError(f"unknown fault action {self.action!r}; "
                             "expected 'raise', 'nan' or 'kill'")
        if self.nth is not None and self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.nth is not None and self.p is not None:
            raise ValueError("give nth OR p, not both")


class FaultPlan:
    """An installable set of :class:`FaultSpec` triggers with deterministic
    per-point call counting and seeded probability streams.

    Install exactly one plan at a time (``install()``/``uninstall()`` or the
    ``active()`` context manager).  Counters reset at install, so a plan is
    reusable and every installation replays identically."""

    def __init__(self, specs, seed: int = 0, strict: bool = True):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs)
        self.seed = int(seed)
        self.strict = bool(strict)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}
        self._rngs: Dict[int, np.random.Generator] = {}
        self.fired: list = []    #: (point, spec index, call number) log

    def _reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self._fires.clear()
            self.fired = []
            self._rngs = {
                i: np.random.default_rng(
                    [self.seed,
                     int.from_bytes(hashlib.sha1(
                         s.point.encode()).digest()[:4], "big"), i])
                for i, s in enumerate(self.specs)}

    # --- lifecycle -----------------------------------------------------------
    def install(self) -> "FaultPlan":
        global _ACTIVE
        if self.strict:
            known = registered_points()
            for s in self.specs:
                if s.point not in known:
                    raise ValueError(
                        f"unknown injection point {s.point!r}; registered: "
                        f"{sorted(known)} (strict=False skips this check)")
        self._reset()
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def active(self):
        """``with plan.active(): ...`` — install on enter, uninstall on
        exit (exceptions included)."""
        return _PlanContext(self)

    # --- firing --------------------------------------------------------------
    def _arm(self, point: str, ctx: Optional[dict]) -> Optional[FaultSpec]:
        """One call at ``point``: count it and return the firing spec (first
        match wins), or None."""
        with self._lock:
            n = self._calls.get(point, 0) + 1
            self._calls[point] = n
            for i, s in enumerate(self.specs):
                if s.point != point:
                    continue
                if s.max_fires is not None \
                        and self._fires.get(i, 0) >= s.max_fires:
                    continue
                if s.match is not None and not s.match(ctx or {}):
                    continue
                if s.nth is not None:
                    if n != s.nth:
                        continue
                elif s.p is not None:
                    if self._rngs[i].random() >= s.p:
                        continue
                self._fires[i] = self._fires.get(i, 0) + 1
                self.fired.append((point, i, n))
                return s
        return None

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls.get(point, 0)


class _PlanContext:
    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return self.plan.install()

    def __exit__(self, *exc) -> None:
        self.plan.uninstall()


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def _execute(spec: FaultSpec, point: str) -> None:
    if spec.action == "kill":
        # a crashed host: no cleanup, no atexit, no finally blocks
        os.kill(os.getpid(), signal.SIGKILL)
    if spec.action == "raise":
        raise spec.exc(f"injected fault at {point!r}")
    # action == "nan" at a control-only seam: nothing to poison — no-op


def fault_point(name: str, ctx: Optional[dict] = None) -> None:
    """Control seam: raises (or kills) when the installed plan fires here.
    A single global check when no plan is installed."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan._arm(name, ctx)
    if spec is not None:
        _execute(spec, name)


def corrupt_point(name: str, value: Any, ctx: Optional[dict] = None) -> Any:
    """Result seam: passes ``value`` through, poisoned with NaN when a
    ``"nan"`` spec fires (``member`` selects the leading-axis index of a
    batched value); ``"raise"``/``"kill"`` specs behave as at
    :func:`fault_point`."""
    plan = _ACTIVE
    if plan is None:
        return value
    spec = plan._arm(name, ctx)
    if spec is None:
        return value
    if spec.action != "nan":
        _execute(spec, name)
        return value
    return _poison(value, spec.member)


def _poison(value: Any, member: Optional[int]) -> Any:
    """One NaN written into a copy of ``value`` (a tensor or numpy array):
    into batch member ``member`` when given, else into the first element —
    enough for any finite-ness check to trip, cheap enough to leave the
    rest bit-intact."""
    import torch
    arr = value.clone() if isinstance(value, torch.Tensor) \
        else np.array(value, copy=True)
    if member is not None:
        idx = (member,) + (0,) * (arr.ndim - 1)
    else:
        idx = (0,) * arr.ndim
    arr[idx] = float("nan")
    return arr
