"""Declarative service configuration: dict/JSON -> booted service (the
reference's ``serve/config.py``).

Every config object can be built from a plain dict — so a whole service is
one JSON document away — while accepting already-constructed
``StencilProblem`` / ``RunConfig`` objects for programmatic use::

    cfg = ServiceConfig.make({
        "buckets": [
            {"problem": {"stencil": "diffusion2d", "shape": [4096, 4096]},
             "run": {"backend": "hopper", "par_time": 8, "bsize": 256},
             "max_batch": 8, "max_wait_ms": 2.0, "queue_cap": 32},
        ],
    })
    service = await repro_torch.serve.serve(cfg)   # booted + pre-warmed

A bucket's ``run`` is the port's :class:`RunConfig`: its ``device``
defaults to ``"cuda"`` (``"cpu"`` serves through the kernels' plain
versions); ``"autotune"`` and the tuning keys pass through, and the
service builds each bucket's plan off the event loop
(``asyncio.to_thread``), so a measured tune at boot does not block it.
A ``"distributed"`` bucket takes its ``mesh`` (``launch/mesh.py``, an
object, so the bucket is built in Python) and ``axis_map`` as the
reference's does.  Reference ``RunConfig`` keys that mean nothing here
are refused by name (:data:`REFUSED_RUN_KEYS`), never ignored.

A :class:`BucketConfig` declares one admission bucket: the exact problem it
serves, how to run it, and the coalescing/backpressure policy.  The bucket
set is closed at boot — that is what makes pre-warming the executable and
schedule caches possible.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.resilience import BreakerConfig, HealthPolicy, RetryPolicy
from repro_torch.serve.request import bucket_key

#: reference ``RunConfig`` keys the port's buckets refuse, and why
REFUSED_RUN_KEYS = {
    "interpret": "Pallas interpret mode has no counterpart; "
                 "device='cpu' runs the kernels' plain versions",
    "exec_cache": "it selects XLA's executable cache, which PyTorch does "
                  "not have (it runs eagerly)",
    "block_parallel": "it is the TPU's megacore split; the kernel's grid "
                      "spreads blocks and batch members over every SM",
}


def _default_batch_classes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself: the
    pre-warmed batch sizes a coalesced launch is padded up to.  A small
    closed set keeps the executable cache small (one compiled program per
    class) while wasting at most ~2x compute on a worst-case fill."""
    classes = []
    c = 1
    while c < max_batch:
        classes.append(c)
        c *= 2
    classes.append(max_batch)
    return tuple(classes)


def _make_problem(spec) -> StencilProblem:
    if isinstance(spec, StencilProblem):
        return spec
    if isinstance(spec, dict):
        spec = dict(spec)
        stencil = spec.pop("stencil", None)
        shape = spec.pop("shape", None)
        if stencil is None or shape is None:
            raise ValueError("bucket problem dict needs 'stencil' and "
                             f"'shape'; got keys {sorted(spec)}")
        return StencilProblem(stencil, tuple(int(d) for d in shape), **spec)
    raise ValueError(f"bucket 'problem' must be a StencilProblem or a dict, "
                     f"got {type(spec).__name__}")


def _make_run(spec) -> RunConfig:
    if spec is None:
        return RunConfig()
    if isinstance(spec, RunConfig):
        return spec
    if isinstance(spec, dict):
        for key in spec:
            if key in REFUSED_RUN_KEYS:
                raise ValueError(f"bucket run key {key!r} is refused: "
                                 f"{REFUSED_RUN_KEYS[key]}")
        return RunConfig(**spec)
    raise ValueError(f"bucket 'run' must be a RunConfig or a dict, "
                     f"got {type(spec).__name__}")


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """One admission bucket: problem + RunConfig + coalescing policy.

    Parameters
    ----------
    problem:
        The exact :class:`StencilProblem` this bucket serves (or a dict
        with ``stencil``/``shape`` and optional ``dtype``/``boundary``).
        Requests whose (fingerprint, state shape, BC, dtype) match are
        admitted here.
    run:
        How to execute: the port's :class:`RunConfig` or a kwargs dict
        (``device`` defaults to ``"cuda"``).
    max_batch:
        Most real requests coalesced into one ``run_batch`` launch.
    max_wait_ms:
        Coalescing window: after the first request arrives the launch waits
        at most this long for co-batchable traffic (a full batch launches
        immediately).
    queue_cap:
        Bounded admission queue; a submit beyond this depth is rejected
        with :class:`~repro_torch.serve.request.ServiceOverloaded`,
        never silently dropped.
    batch_classes:
        The pre-warmed batch sizes; a launch of B real requests is padded
        (batch-axis edge replication — bit-exact, members are independent)
        up to the smallest class >= B.  Default: powers of two up to
        ``max_batch``.
    max_rounds:
        Most *distinct* iteration counts one launch carries: mixed-iters
        batches advance in stages (run to the smallest iters, deliver the
        finished members, keep going), so each extra distinct value costs
        one more round on the full padded batch.
    name:
        Metrics/debugging label (defaults to ``stencil@shape``).
    """
    problem: Union[StencilProblem, dict]
    run: Union[RunConfig, dict, None] = None
    max_batch: int = 8
    max_wait_ms: float = 2.0
    queue_cap: int = 64
    batch_classes: Optional[Tuple[int, ...]] = None
    max_rounds: int = 4
    name: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "problem", _make_problem(self.problem))
        object.__setattr__(self, "run", _make_run(self.run))
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, "
                             f"got {self.max_wait_ms}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")
        if self.batch_classes is None:
            classes = _default_batch_classes(self.max_batch)
        else:
            classes = tuple(sorted({int(c) for c in self.batch_classes}))
            if not classes or classes[0] < 1:
                raise ValueError(f"batch_classes must be positive, "
                                 f"got {self.batch_classes}")
            if classes[-1] < self.max_batch:
                raise ValueError(
                    f"max(batch_classes)={classes[-1]} < max_batch="
                    f"{self.max_batch}: a full batch would have no class "
                    "to pad up to")
        object.__setattr__(self, "batch_classes", classes)
        if self.name is None:
            shape = "x".join(str(d) for d in self.problem.shape)
            object.__setattr__(
                self, "name", f"{self.problem.stencil.name}@{shape}")

    @property
    def key(self) -> tuple:
        return bucket_key(self.problem)

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_ms / 1e3

    def pad_to_class(self, n: int) -> int:
        """Smallest pre-warmed batch class >= n."""
        for c in self.batch_classes:
            if c >= n:
                return c
        return self.batch_classes[-1]

    @classmethod
    def make(cls, spec) -> "BucketConfig":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        raise ValueError(f"bucket spec must be a BucketConfig or a dict, "
                         f"got {type(spec).__name__}")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """The whole service: the closed bucket set plus global policy.

    ``max_concurrent_batches`` bounds how many coalesced launches may be in
    flight at once across buckets (1 serializes the device; >1 runs each
    slot's launches on a CUDA stream of its own, so they can overlap).
    ``offload_compute`` moves each launch's host work into a worker thread
    so the event loop stays responsive during it; the default (``None``)
    picks automatically — offload only when launches can overlap
    (``max_concurrent_batches > 1``), because on a serialized device the
    thread hop only adds context switches to the critical path.
    ``drain_timeout_s`` bounds graceful shutdown: ``stop()`` flushes every
    admitted request, then gives up after this long.

    Resilience policy (all three accept an instance, a kwargs dict, a
    bool, or ``None`` for the defaults):

    * ``health`` — per-request numerical health check on delivered results
      (:class:`~repro_torch.resilience.HealthPolicy`; **on by default** —
      per-member reductions on the device, one host transfer a round).  A
      member that fails is quarantined with
      :class:`~repro_torch.serve.request.NumericalFault`; healthy
      co-batched neighbors are delivered unchanged, bit-identical to a
      fault-free run.
    * ``retry`` — capped-exponential launch retry budget
      (:class:`~repro_torch.resilience.RetryPolicy`; ``False`` = no
      retries).  When a multi-member launch spends it, the batch is
      bisected to isolate the poison member(s); the healthy remainder is
      retried.
    * ``breaker`` — per-bucket circuit breaker
      (:class:`~repro_torch.resilience.BreakerConfig`; ``False``
      disables):
      consecutive launch failures degrade the bucket from coalesced to
      per-request launches, then to rejecting admissions with retry-after.
    * ``checkpoint_dir`` — root directory for serving-side checkpointed
      requests (``StencilRequest.checkpoint_key``); ``None`` (default)
      rejects such requests at admission.
    """
    buckets: Tuple[Union[BucketConfig, dict], ...] = ()
    max_concurrent_batches: int = 1
    offload_compute: Optional[bool] = None
    drain_timeout_s: float = 30.0
    health: Union[HealthPolicy, dict, bool, None] = None
    retry: Union[RetryPolicy, dict, bool, None] = None
    breaker: Union[BreakerConfig, dict, bool, None] = None
    checkpoint_dir: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "health", HealthPolicy.make(self.health))
        object.__setattr__(self, "retry", RetryPolicy.make(self.retry))
        object.__setattr__(self, "breaker", BreakerConfig.make(self.breaker))
        buckets = tuple(BucketConfig.make(b) for b in self.buckets)
        if not buckets:
            raise ValueError("a service needs at least one bucket")
        if self.max_concurrent_batches < 1:
            raise ValueError(f"max_concurrent_batches must be >= 1, got "
                             f"{self.max_concurrent_batches}")
        if self.drain_timeout_s <= 0:
            raise ValueError(f"drain_timeout_s must be > 0, got "
                             f"{self.drain_timeout_s}")
        seen = {}
        for b in buckets:
            if b.key in seen:
                raise ValueError(
                    f"buckets {seen[b.key]!r} and {b.name!r} serve the same "
                    "(stencil, shape, bc, dtype) — merge them")
            seen[b.key] = b.name
        object.__setattr__(self, "buckets", buckets)

    @classmethod
    def make(cls, spec) -> "ServiceConfig":
        """Normalize any spec form: ServiceConfig | dict | JSON string."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            spec = json.loads(spec)
        if isinstance(spec, dict):
            return cls(**spec)
        if isinstance(spec, (list, tuple)):
            return cls(buckets=tuple(spec))
        raise ValueError(f"service spec must be a ServiceConfig, dict, "
                         f"JSON string or bucket list, "
                         f"got {type(spec).__name__}")
