"""Request-facing types of the serving subsystem (the reference's
``serve/request.py``; grids travel as numpy arrays or CPU tensors).

A :class:`StencilRequest` is one unit of admission: a grid to advance, an
iteration count, and (optionally) run-time coefficients, an aux stream, and
a deadline.  The service answers with a :class:`ServeResult` or one of the
typed rejections below — a request is **never silently dropped**: every
admitted request either resolves to a result or fails with an explicit
:class:`ServeError` subclass.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from repro_torch.api.problem import StencilProblem
from repro_torch.api.schedule_cache import stencil_fingerprint
from repro_torch.resilience.health import LaunchFailed as _LaunchFailed
from repro_torch.resilience.health import NumericalFault as _NumericalFault


# --- typed rejections --------------------------------------------------------

class ServeError(Exception):
    """Base class of every serving-path failure the service raises."""


class ServiceOverloaded(ServeError):
    """The target bucket's admission queue is full (backpressure — the
    429-style rejection).  ``retry_after_s`` is the service's hint for when
    capacity is expected: roughly the queued work ahead divided by the
    bucket's recent batch throughput."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServeError):
    """The request's deadline expired while it was still queued — the
    service fails it instead of spending compute on a result nobody will
    read."""


class NoMatchingBucket(ServeError):
    """No declared bucket covers this request's (stencil fingerprint, grid
    shape, boundary condition, dtype).  The bucket set is declared at boot
    (``ServiceConfig``) so executables can be pre-warmed; arbitrary shapes
    go through ``plan().run()`` directly."""


class ServiceClosed(ServeError):
    """The service is draining or stopped; no new admissions."""


class LaunchFailed(ServeError, _LaunchFailed):
    """A coalesced launch kept failing after its whole retry budget (and,
    for multi-member batches, after bisection isolated this request as a
    culprit).  Subclasses both :class:`ServeError` and the resilience
    layer's ``LaunchFailed`` so clients can catch either family;
    ``attempts`` counts tries, ``__cause__`` carries the last error."""


class NumericalFault(ServeError, _NumericalFault):
    """This request's result failed the bucket's numerical health check
    (NaN/Inf cells or amplitude blowup) — the *request* is quarantined and
    failed; healthy co-batched neighbors are delivered unchanged.  Carries
    the resilience fault's ``kind`` / ``member`` / ``max_abs`` fields."""


# --- the request/result pair -------------------------------------------------

def _normalize_problem(problem, grid) -> StencilProblem:
    if isinstance(problem, StencilProblem):
        return problem
    # name / Stencil / stage-sequence forms: the grid supplies the shape
    # AND the storage dtype — a bf16 tensor must land in a bf16 bucket, not
    # silently inherit the f32 default (single-field only — multi-field
    # programs carry a (F, *shape) state stack, so their requests must pass
    # a full StencilProblem)
    shape = tuple(int(d) for d in grid.shape)
    dtype = getattr(grid, "dtype", "float32")
    return StencilProblem(problem, shape, dtype=dtype)


@dataclasses.dataclass
class StencilRequest:
    """One serving request: advance ``grid`` by ``iters`` program iterations.

    Parameters
    ----------
    problem:
        What to compute: a :class:`~repro_torch.api.problem.StencilProblem`,
        or a
        registered stencil name (the grid then supplies the shape; default
        clamp BC).  The problem's (stencil fingerprint, state shape,
        boundary condition, dtype) selects the bucket.
    grid:
        Initial state, ``problem.state_shape``-shaped: a numpy array or a
        CPU tensor (a bf16 state is a tensor: numpy has no bf16).
    iters:
        Program iterations to advance (>= 1).
    coeffs:
        Run-time coefficient overrides (as for ``StencilPlan.run``).
        Requests coalesce into one ``run_batch`` call only with requests
        whose *resolved* coefficients agree — a different dt/conductivity
        sub-groups the bucket, it never corrupts neighbors.
    aux:
        Auxiliary input grid (Hotspot's ``power``), required iff the
        problem needs one.  Per-request aux grids batch together.
    deadline_s:
        Relative deadline: if the request is still queued this many seconds
        after submission, it fails with :class:`DeadlineExceeded` instead
        of launching.
    checkpoint_key:
        Opt into checkpointed execution: the run is chunked and each chunk's
        state lands atomically under
        ``<ServiceConfig.checkpoint_dir>/<checkpoint_key>`` — resubmitting
        the *same key* after a crash (the service's, or an injected one)
        resumes from the last complete super-step instead of starting over.
        Keys name the computation, so they must be unique per logical run.
        A checkpointed request never coalesces with other traffic (its
        launch is stateful) and requires ``checkpoint_every``.
    checkpoint_every:
        Checkpoint cadence in program iterations (rounded up to the plan's
        super-step length, so chunk seams stay bit-exact).
    """
    problem: Union[StencilProblem, str, Any]
    grid: Any
    iters: int
    coeffs: Optional[Any] = None
    aux: Optional[Any] = None
    deadline_s: Optional[float] = None
    checkpoint_key: Optional[str] = None
    checkpoint_every: Optional[int] = None

    def __post_init__(self):
        self.problem = _normalize_problem(self.problem, self.grid)
        self.iters = int(self.iters)
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if tuple(self.grid.shape) != self.problem.state_shape:
            raise ValueError(
                f"grid shape {tuple(self.grid.shape)} != problem state "
                f"shape {self.problem.state_shape}")
        if self.deadline_s is not None:
            self.deadline_s = float(self.deadline_s)
            if self.deadline_s <= 0:
                raise ValueError(
                    f"deadline_s must be > 0, got {self.deadline_s}")
        if self.problem.needs_aux:
            if self.aux is None:
                raise ValueError(
                    f"{self.problem.stencil.name} needs an aux grid")
            if tuple(self.aux.shape) != self.problem.shape:
                raise ValueError(
                    f"aux shape {tuple(self.aux.shape)} != problem shape "
                    f"{self.problem.shape}")
        elif self.aux is not None:
            raise ValueError(
                f"{self.problem.stencil.name} takes no aux grid")
        if self.checkpoint_key is not None:
            if not isinstance(self.checkpoint_key, str) \
                    or not self.checkpoint_key \
                    or "/" in self.checkpoint_key \
                    or self.checkpoint_key in (".", ".."):
                raise ValueError(
                    f"checkpoint_key must be a non-empty path-component "
                    f"string, got {self.checkpoint_key!r}")
            if self.checkpoint_every is None:
                raise ValueError(
                    "a checkpointed request needs checkpoint_every")
            self.checkpoint_every = int(self.checkpoint_every)
            if self.checkpoint_every < 1:
                raise ValueError(f"checkpoint_every must be >= 1, "
                                 f"got {self.checkpoint_every}")
        elif self.checkpoint_every is not None:
            raise ValueError("checkpoint_every requires checkpoint_key")

    @property
    def bucket_key(self) -> tuple:
        return bucket_key(self.problem)


def bucket_key(problem: StencilProblem) -> tuple:
    """What makes two requests batchable into one executable: the stencil/
    program *fingerprint* (not just the name — user stencils can change
    under one name), the exact state shape, the boundary condition, and the
    dtype.  Grid shapes are NOT padded across requests: spatial edge
    padding changes clamp semantics from the second iteration on (the pad
    cells evolve freely instead of tracking the edge — see DESIGN.md §2.6),
    so a bucket serves exactly one shape and padding happens along the
    batch axis only, which is bit-exact."""
    return (stencil_fingerprint(problem.stencil), problem.state_shape,
            problem.bc.token(), problem.dtype)


@dataclasses.dataclass
class ServeResult:
    """A completed request: the advanced grid (a CPU tensor, a view into
    the launch round's pinned host copy on a card) plus serving
    telemetry."""
    grid: Any
    iters: int
    #: end-to-end seconds from admission to delivery
    latency_s: float
    #: name of the bucket that served the request
    bucket: str
    #: real requests in the coalesced launch (before batch-class padding)
    batch_size: int
    #: real / padded batch size of the launch this request rode in
    batch_fill: float
    #: staged-advance rounds the launch ran (1 unless iters were mixed)
    rounds: int
