"""Numerical health guards: NaN/Inf/amplitude-blowup detection, on the
device.

A :class:`HealthPolicy` is the cheap invariant check that runs on
super-step boundaries: "is this grid still finite, and is its amplitude
still sane?"  The reference checks on the host; here the reductions run
where the grid lives: per batch member, ``isnan``/``isinf`` and the
largest magnitude (``aminmax``, so no ``abs()`` copy of the grid), in the
storage dtype and widened to float32 afterwards (exact for bf16), with one
``.cpu()`` for the whole batch.  It turns a silent NaN-producing request
into a structured, per-request :class:`NumericalFault` with the reference's
``kind``, ``member`` and message.

The exceptions are the resilience layer's vocabulary;
``repro_torch.serve`` subclasses them into its ``ServeError`` hierarchy so
a serving client can catch either family.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


class ResilienceError(Exception):
    """Base class of the resilience layer's structured failures."""


class NumericalFault(ResilienceError):
    """A grid failed its health check.  ``kind`` is ``"nan"``, ``"inf"`` or
    ``"blowup"``; ``member`` is the batch index when the check ran on one
    member of a coalesced launch; ``max_abs`` is the observed amplitude."""

    def __init__(self, message: str, *, kind: str = "nan",
                 member: Optional[int] = None,
                 max_abs: Optional[float] = None):
        super().__init__(message)
        self.kind = kind
        self.member = member
        self.max_abs = max_abs


class LaunchFailed(ResilienceError):
    """A launch kept failing after the retry budget was spent.
    ``attempts`` counts tries; ``__cause__`` carries the last underlying
    error."""

    def __init__(self, message: str, *, attempts: int = 1):
        super().__init__(message)
        self.attempts = attempts


class CheckpointMismatch(ResilienceError):
    """A checkpoint directory holds state for a different computation
    (fingerprint / shape / dtype / iters disagree): resuming from it would
    silently compute garbage, so it is refused loudly."""


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When (and how hard) to judge a grid unhealthy.

    ``check_nonfinite`` fails on any NaN or Inf cell (the default);
    ``max_abs`` is an amplitude ceiling whose excess fails with
    ``kind="blowup"`` (``None`` disables it); ``enabled`` is the master
    switch: a disabled policy checks nothing."""
    check_nonfinite: bool = True
    max_abs: Optional[float] = None
    enabled: bool = True

    @classmethod
    def make(cls, spec) -> "HealthPolicy":
        """Normalize config forms: policy | dict | bool | None (defaults)."""
        if isinstance(spec, cls):
            return spec
        if spec is None or spec is True:
            return cls()
        if spec is False:
            return cls(enabled=False)
        if isinstance(spec, dict):
            return cls(**spec)
        raise ValueError(f"health spec must be a HealthPolicy, dict or bool, "
                         f"got {type(spec).__name__}")

    # --- checks --------------------------------------------------------------
    def faults_of(self, grids, *, members=None,
                  where: str = "") -> List[Optional[NumericalFault]]:
        """One :class:`NumericalFault` or ``None`` per member of the batch
        ``grids`` (a tensor or numpy array with a leading batch axis),
        reduced on the grids' device and brought to the host in one
        transfer.  ``members`` names the members in the faults (default
        ``0 .. B-1``)."""
        grids = torch.as_tensor(grids)
        n = grids.shape[0]
        members = list(range(n)) if members is None else list(members)
        if not self.enabled or n == 0:
            return [None] * n
        flat = grids.reshape(n, -1)
        if flat.shape[1] == 0:
            return [None] * n
        if not flat.is_floating_point():
            flat = flat.float()
        lo, hi = torch.aminmax(flat, dim=1)
        stats = torch.stack([flat.isnan().any(1).to(torch.float32),
                             flat.isinf().any(1).to(torch.float32),
                             torch.maximum(-lo, hi).to(torch.float32)])
        nan, inf, amax = stats.cpu().tolist()
        tag = f" in {where}" if where else ""
        out: List[Optional[NumericalFault]] = []
        for i, member in enumerate(members):
            at = "" if member is None else f" (batch member {member})"
            fault = None
            if self.check_nonfinite and nan[i]:
                fault = NumericalFault(f"NaN cells{tag}{at}", kind="nan",
                                       member=member)
            elif self.check_nonfinite and inf[i]:
                fault = NumericalFault(f"Inf cells{tag}{at}", kind="inf",
                                       member=member)
            elif self.max_abs is not None and amax[i] > self.max_abs:
                fault = NumericalFault(
                    f"amplitude blowup{tag}{at}: max|x|={amax[i]:.3e} > "
                    f"{self.max_abs:.3e}", kind="blowup", member=member,
                    max_abs=amax[i])
            out.append(fault)
        return out

    def fault_of(self, grid, *, member: Optional[int] = None,
                 where: str = "") -> Optional[NumericalFault]:
        """The :class:`NumericalFault` this grid deserves, or ``None``."""
        return self.faults_of(torch.as_tensor(grid)[None], members=[member],
                              where=where)[0]

    def check(self, grid, *, where: str = "") -> None:
        """Raise the grid's :class:`NumericalFault`, if any."""
        fault = self.fault_of(grid, where=where)
        if fault is not None:
            raise fault
