"""The asyncio stencil service: admission -> coalesce -> padded run_batch
(the reference's ``serve/service.py``, over the port's plans).

Request lifecycle::

    submit(StencilRequest)                       (event loop)
      └─ bucket lookup by (fingerprint, state shape, BC, dtype)
         └─ bounded-queue admission  — full -> ServiceOverloaded(retry_after)
            └─ per-bucket worker coalesces under (max_batch, max_wait_ms)
               └─ deadline sweep     — expired -> DeadlineExceeded
                  └─ batch padded to a pre-warmed batch class (edge
                     replication along the batch axis — bit-exact), staged
                     in pinned host memory, copied to the card, advanced by
                     staged run_batch rounds (one launch per super-step
                     for the whole batch), health-checked on the card and
                     copied back once a round         (compute, a CUDA stream)
                     └─ futures resolved with ServeResult   (event loop)

Where it differs from the reference:

* **Staging.**  Per bucket, batch class and launch slot, a pinned host
  buffer is filled in place and copied to the card with one non-blocking
  copy; an event recorded after the copy keeps the buffer from being
  refilled before the copy has read it.  On the CPU the batch is stacked
  into a fresh tensor.
* **Delivery.**  One device-to-host copy of the round's real members into
  pinned memory, then a sync; ``ServeResult.grid`` is a CPU tensor (a view
  of that copy) where the reference hands out a numpy view.
* **Health.**  The per-member check reduces on the card, one host transfer
  a round (``HealthPolicy.faults_of``).
* **Concurrency.**  Each of the ``max_concurrent_batches`` launch slots
  runs its launches on a CUDA stream of its own (the launcher reads the
  current stream), inline on the loop or, with ``offload_compute``, in a
  worker thread.

No launch falls back: a kernel that fails to build or launch raises, the
retry ladder may retry the same launch, and a member that still fails ends
with :class:`LaunchFailed`; nothing is routed to the CPU.
"""
from __future__ import annotations

import asyncio
import os
import threading
import time
from typing import Dict, List, Optional, Union

import torch

# the seams of checkpointed requests (checkpoint.save, checkpoint.restore)
# register when the checkpoint module is imported
import repro_torch.checkpoint  # noqa: F401
from repro_torch.api.plan import StencilPlan, plan as make_plan
from repro_torch.resilience.checkpoint_run import run_checkpointed
from repro_torch.resilience.faults import fault_point, register_point
from repro_torch.resilience.health import CheckpointMismatch
from repro_torch.resilience.health import NumericalFault as _ResNumericalFault
from repro_torch.resilience.retry import CircuitBreaker
from repro_torch.serve.batcher import BucketState, PendingRequest
from repro_torch.serve.config import BucketConfig, ServiceConfig
from repro_torch.serve.metrics import ServiceMetrics
from repro_torch.serve.request import (DeadlineExceeded, LaunchFailed,
                                       NoMatchingBucket, NumericalFault,
                                       ServeResult, ServiceClosed,
                                       ServiceOverloaded, StencilRequest)

#: fires at the head of every coalesced launch's compute (possibly on a
#: worker thread): a raise here exercises retry -> bisection -> breaker
#: without touching any backend internals
FP_LAUNCH = register_point(
    "serve.launch", "at the head of a coalesced run_batch launch "
    "(ctx: bucket, batch size, member seqs)")

#: signature of a request with no coefficient overrides: all such requests
#: of a bucket resolve alike, so a sentinel groups them without resolving
_DEFAULT_SIG = ("@default-coeffs",)


def coeffs_signature(problem, coeffs):
    """Hashable identity of the *resolved* coefficient payload.  Two
    requests coalesce into one ``run_batch`` call only when these agree —
    the call takes a single coefficient set for the whole batch."""
    if not coeffs:
        return _DEFAULT_SIG
    resolved = problem.resolve_coeffs(coeffs)
    return tuple((name, float(stage[name]))
                 for stage in resolved for name in sorted(stage))


class _Staging:
    """Pinned host buffers of one bucket, one per (what, batch class,
    launch slot): ``to_device`` fills one in place (the members, then the
    last member again up to the class) and copies it to the card with one
    non-blocking copy on the current stream, recording an event after it;
    the next fill of that buffer waits for the event first."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.dtype, self.device = dtype, device
        self._bufs: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    def _fill(self, host: torch.Tensor, arrays) -> None:
        for i, a in enumerate(arrays):
            host[i].copy_(torch.as_tensor(a))
        if len(arrays) < host.shape[0]:
            host[len(arrays):].copy_(host[len(arrays) - 1].expand_as(
                host[len(arrays):]))

    def to_device(self, key: tuple, arrays, padded: int,
                  shape: tuple) -> torch.Tensor:
        """``(padded, *shape)`` on the device: ``arrays`` edge-padded."""
        if self.device.type != "cuda":
            host = torch.empty((padded,) + shape, dtype=self.dtype)
            self._fill(host, arrays)
            return host
        with self._lock:
            entry = self._bufs.get((key, padded))
            if entry is None:
                entry = (torch.empty((padded,) + shape, dtype=self.dtype,
                                     pin_memory=True),
                         torch.cuda.Event(), threading.Lock())
                self._bufs[(key, padded)] = entry
        host, done, busy = entry
        with busy:
            done.synchronize()      # the buffer's last copy has read it
            self._fill(host, arrays)
            dev = torch.empty_like(host, device=self.device)
            dev.copy_(host, non_blocking=True)
            done.record()
        return dev


class _Bucket:
    """Runtime state of one configured bucket."""

    def __init__(self, cfg: BucketConfig, breaker: Optional[CircuitBreaker]):
        self.cfg = cfg
        self.state = BucketState(cfg)
        self.plan: Optional[StencilPlan] = None
        self.staging = _Staging(cfg.problem.torch_dtype, cfg.run.device)
        self.wake: Optional[asyncio.Event] = None   # bound at start()
        self.task: Optional[asyncio.Task] = None
        #: trailing per-launch seconds (retry-after estimation)
        self.last_batch_s: float = 0.0
        #: per-bucket circuit breaker (None when disabled in ServiceConfig)
        self.breaker = breaker


class StencilService:
    """Bucketed, coalescing, pre-warmed stencil server.

    Build one directly and ``await service.start()``, or use the
    :func:`serve` / :func:`from_config` factories.  ``clock`` is injectable
    for deterministic tests (it must agree with the loop's notion of
    elapsed real time, since coalescing windows sleep on the loop)."""

    def __init__(self, config: Union[ServiceConfig, dict, str, list], *,
                 clock=time.monotonic):
        self.config = ServiceConfig.make(config)
        self._clock = clock
        self.metrics = ServiceMetrics(clock=clock)
        self._buckets: Dict[tuple, _Bucket] = {}
        for bcfg in self.config.buckets:
            breaker = (CircuitBreaker(self.config.breaker)
                       if self.config.breaker is not None else None)
            self._buckets[bcfg.key] = _Bucket(bcfg, breaker)
        self._started = False
        self._closing = False
        self._closed = False
        self._seq = 0
        self._offload = (self.config.offload_compute
                         if self.config.offload_compute is not None
                         else self.config.max_concurrent_batches > 1)
        self._sem: Optional[asyncio.Semaphore] = None
        #: launch slots not in use; slot i runs on stream i of its device
        self._free_slots = list(range(self.config.max_concurrent_batches))
        self._streams: Dict[tuple, "torch.cuda.Stream"] = {}
        #: in-flight coalesced launches (tasks) — awaited by stop()
        self._launches: set = set()

    # --- lifecycle ----------------------------------------------------------
    async def start(self, prewarm: bool = True) -> "StencilService":
        """Boot: build every bucket's plan, optionally pre-warm the kernels
        for the declared batch classes, spawn the workers."""
        if self._started:
            raise RuntimeError("service already started")
        self._sem = asyncio.Semaphore(self.config.max_concurrent_batches)
        for b in self._buckets.values():
            b.plan = await asyncio.to_thread(
                make_plan, b.cfg.problem, b.cfg.run)
            if prewarm:
                t0 = self._clock()
                await asyncio.to_thread(self._prewarm_bucket, b)
                self.metrics.note_prewarm(b.cfg.name, self._clock() - t0)
        for b in self._buckets.values():
            b.wake = asyncio.Event()
            b.task = asyncio.create_task(self._worker(b),
                                         name=f"serve-{b.cfg.name}")
            self.metrics.note_breaker(
                b.cfg.name, "disabled" if b.breaker is None
                else b.breaker.mode(self._clock()))
        self._started = True
        self.metrics.note_started()
        return self

    async def stop(self, drain: bool = True) -> None:
        """Graceful shutdown: refuse new admissions, flush queued requests
        (``drain=True``) or fail them with :class:`ServiceClosed`, join the
        workers."""
        if self._closed:
            return
        self._closing = True
        if not drain:
            for b in self._buckets.values():
                while b.state.pending:
                    rec = b.state.pending.popleft()
                    self._fail(rec, ServiceClosed("service stopped"), "closed")
        for b in self._buckets.values():
            if b.wake is not None:
                b.wake.set()
        tasks = [b.task for b in self._buckets.values() if b.task is not None]
        if tasks:
            done, pending = await asyncio.wait(
                tasks, timeout=self.config.drain_timeout_s)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        # the workers only dispatch launches; join the in-flight ones so
        # every admitted request gets its answer before we close
        if self._launches:
            await asyncio.gather(*list(self._launches),
                                 return_exceptions=True)
        for b in self._buckets.values():
            while b.state.pending:
                rec = b.state.pending.popleft()
                self._fail(rec, ServiceClosed("drain timed out"), "closed")
        self._closed = True

    async def __aenter__(self) -> "StencilService":
        if not self._started:
            await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # --- admission ----------------------------------------------------------
    async def submit(self, request: StencilRequest) -> ServeResult:
        """Admit one request and await its result.  Raises the typed
        rejections (:class:`ServiceOverloaded`, :class:`DeadlineExceeded`,
        :class:`NoMatchingBucket`, :class:`ServiceClosed`) — admission
        errors synchronously, queued failures through the future."""
        return await self.submit_nowait(request)

    def submit_nowait(self, request: StencilRequest) -> "asyncio.Future":
        """Admit without awaiting: returns the result future (open-loop
        load generation), raising admission rejections immediately."""
        if not self._started:
            raise RuntimeError("service not started — await start() first")
        if not isinstance(request, StencilRequest):
            raise TypeError(f"submit takes a StencilRequest, "
                            f"got {type(request).__name__}")
        now = self._clock()
        self.metrics.note_submitted()
        if self._closing:
            self.metrics.note_rejected("closed")
            raise ServiceClosed("service is draining; resubmit elsewhere")
        b = self._buckets.get(request.bucket_key)
        if b is None:
            self.metrics.note_rejected("no_bucket")
            raise NoMatchingBucket(
                f"no bucket serves {request.problem.stencil.name} "
                f"{request.problem.state_shape} "
                f"bc={request.problem.bc.token()} "
                f"dtype={request.problem.dtype}; declared: "
                f"{[bk.cfg.name for bk in self._buckets.values()]}")
        if b.breaker is not None and not b.breaker.admits(now):
            self.metrics.note_rejected("breaker")
            self.metrics.note_breaker(b.cfg.name, b.breaker.mode(now))
            raise ServiceOverloaded(
                f"bucket {b.cfg.name!r} circuit breaker is open (backend "
                f"kept failing); retry after the cooldown",
                retry_after_s=b.breaker.retry_after_s(now))
        if request.checkpoint_key is not None \
                and self.config.checkpoint_dir is None:
            self.metrics.note_rejected("no_bucket")
            raise NoMatchingBucket(
                "request has checkpoint_key but the service has no "
                "checkpoint_dir configured (ServiceConfig.checkpoint_dir)")
        sig = coeffs_signature(request.problem, request.coeffs)
        self._seq += 1
        if request.checkpoint_key is not None:
            # a checkpointed launch is stateful (it writes its own resume
            # directory): a per-admission signature makes it a batch of one
            sig = (sig, ("@ckpt", request.checkpoint_key, self._seq))
        rec = PendingRequest(
            seq=self._seq, request=request, submitted_at=now,
            expires_at=(now + request.deadline_s
                        if request.deadline_s is not None else None),
            coeffs_sig=sig, iters=request.iters,
            future=asyncio.get_running_loop().create_future())
        if not b.state.admit(rec, now):
            self.metrics.note_rejected("overload")
            raise ServiceOverloaded(
                f"bucket {b.cfg.name!r} queue is full "
                f"({b.cfg.queue_cap} pending)",
                retry_after_s=self._retry_after(b))
        depth = b.state.depth()
        self.metrics.note_depth(b.cfg.name, depth)
        # wake the worker only when this admission can change its decision:
        # the queue just became non-empty (arm the window) or a full batch
        # may now exist (early launch)
        if depth == 1 or depth >= b.cfg.max_batch:
            b.wake.set()
        return rec.future

    def _retry_after(self, b: _Bucket) -> float:
        """Backpressure hint: queued launches ahead x trailing launch time,
        floored at one coalescing window."""
        launches_ahead = max(
            1, -(-b.state.depth() // b.cfg.max_batch))   # ceil div
        est = launches_ahead * (b.last_batch_s or b.cfg.max_wait_s)
        return max(est, b.cfg.max_wait_s)

    # --- the per-bucket worker ----------------------------------------------
    async def _worker(self, b: _Bucket) -> None:
        state = b.state
        while True:
            now = self._clock()
            if state.depth() == 0:
                if self._closing:
                    return
                b.wake.clear()
                await b.wake.wait()
                continue
            due = state.ready_at(now)
            if not self._closing and due is not None and due > now:
                # coalescing window still open: sleep until it expires or
                # a new admission re-evaluates (a full batch launches early)
                b.wake.clear()
                try:
                    await asyncio.wait_for(b.wake.wait(), due - now)
                except asyncio.TimeoutError:
                    pass
                continue
            # degraded/probing breaker: one request a launch (blast radius
            # 1); open rejects at admission
            limit = (1 if b.breaker is not None
                     and b.breaker.mode(now) != "closed" else None)
            batch, expired = state.take_batch(now, limit=limit)
            for rec in expired:
                self._fail(rec, DeadlineExceeded(
                    f"deadline expired after "
                    f"{now - rec.submitted_at:.3f}s in queue "
                    f"(bucket {b.cfg.name!r})"), "deadline")
            self.metrics.note_depth(b.cfg.name, state.depth())
            if not batch:
                continue
            # dispatch without awaiting completion: batch assembly overlaps
            # device compute, up to max_concurrent_batches in flight
            await self._sem.acquire()
            task = asyncio.create_task(self._launch(b, batch),
                                       name=f"launch-{b.cfg.name}")
            self._launches.add(task)
            task.add_done_callback(self._launches.discard)

    async def _launch(self, b: _Bucket,
                      batch: List[PendingRequest]) -> None:
        """One coalesced launch through the resilience pipeline, on a launch
        slot of its own (the caller acquired the semaphore)."""
        slot = self._free_slots.pop()
        try:
            await self._resilient_batch(b, batch, slot)
        finally:
            self._free_slots.append(slot)
            self._sem.release()

    async def _resilient_batch(self, b: _Bucket, batch: List[PendingRequest],
                               slot: int) -> None:
        """Launch ``batch``; every member ends resolved or failed — never
        dropped.  The ladder, as in the reference:

        1. the launch is attempted under the retry budget
           (``ServiceConfig.retry``);
        2. a launch that spends the budget is **bisected**: each half is
           relaunched (recursively), so the poison member(s) fail alone
           with :class:`LaunchFailed` and the rest is served, bit-identical
           (members are independent in a batched launch);
        3. delivered members pass the per-member health check; an unhealthy
           one is quarantined with :class:`NumericalFault` while its
           neighbors deliver;
        4. the circuit breaker sees infrastructure outcomes only."""
        t0 = self._clock()
        try:
            outs, faults, padded, rounds = await self._attempt_with_retry(
                b, batch, slot)
        except Exception as e:              # noqa: BLE001 — fail, don't drop
            infra = not isinstance(e, (_ResNumericalFault,
                                       CheckpointMismatch))
            if infra:
                self._note_breaker(b, failed=True)
            if len(batch) > 1 and infra:
                mid = len(batch) // 2
                await self._resilient_batch(b, batch[:mid], slot)
                await self._resilient_batch(b, batch[mid:], slot)
                return
            for rec in batch:
                self._fail_exec(rec, *self._classify(e))
            return
        self._note_breaker(b, failed=False)
        exec_s = self._clock() - t0
        b.last_batch_s = exec_s
        self.metrics.note_batch(len(batch), padded, rounds, exec_s)
        now = self._clock()
        fill = len(batch) / padded
        for i, (rec, out, fault) in enumerate(zip(batch, outs, faults)):
            if fault is not None:
                self._fail_exec(
                    rec, NumericalFault(str(fault), kind=fault.kind,
                                        member=i, max_abs=fault.max_abs),
                    "numerical_fault", quarantined=len(batch) > 1)
                continue
            if rec.future.cancelled():
                continue
            latency = now - rec.submitted_at
            cells = rec.iters
            for d in rec.request.problem.shape:
                cells *= d
            self.metrics.note_completed(latency, cells)
            rec.future.set_result(ServeResult(
                grid=out, iters=rec.iters, latency_s=latency,
                bucket=b.cfg.name, batch_size=len(batch),
                batch_fill=fill, rounds=rounds))

    async def _attempt_with_retry(self, b: _Bucket,
                                  batch: List[PendingRequest], slot: int):
        """Run :meth:`_run_batch` under the retry budget.  Deterministic
        request-side failures (a health fault inside a checkpointed run, a
        checkpoint identity mismatch) are not retried; everything else backs
        off exponentially and, when the budget is spent, raises
        :class:`LaunchFailed` with the last error as ``__cause__``."""
        policy = self.config.retry
        attempt = 0
        while True:
            attempt += 1
            try:
                if self._offload:
                    return await asyncio.to_thread(self._run_batch, b, batch,
                                                   slot)
                return self._run_batch(b, batch, slot)
            except (_ResNumericalFault, CheckpointMismatch):
                raise
            except Exception as e:          # noqa: BLE001 — judged below
                if attempt >= policy.max_attempts:
                    raise LaunchFailed(
                        f"bucket {b.cfg.name!r} launch of {len(batch)} "
                        f"request(s) failed {attempt}x "
                        f"({type(e).__name__}: {e})",
                        attempts=attempt) from e
                self.metrics.note_retry()
                await asyncio.sleep(policy.backoff_s(attempt))

    def _note_breaker(self, b: _Bucket, failed: bool) -> None:
        if b.breaker is None:
            return
        now = self._clock()
        if failed:
            b.breaker.on_failure(now)
        else:
            b.breaker.on_success(now)
        mode = b.breaker.mode(now)
        self.metrics.note_breaker(b.cfg.name, mode)
        if mode != "closed":
            # wake the worker so an already-armed window re-evaluates
            b.wake.set()

    def _fail(self, rec: PendingRequest, exc: Exception, kind: str) -> None:
        self.metrics.note_rejected(kind)
        if rec.future is not None and not rec.future.cancelled():
            rec.future.set_exception(exc)

    def _fail_exec(self, rec: PendingRequest, exc: Exception, kind: str,
                   quarantined: bool = False) -> None:
        """A launch failure is not a rejection: it lands in the ``failed``
        counters and surfaces the typed error on the member's future."""
        self.metrics.note_failed(kind, quarantined=quarantined)
        if rec.future is not None and not rec.future.cancelled():
            rec.future.set_exception(exc)

    @staticmethod
    def _classify(e: Exception):
        """(exception to surface, FAIL_KINDS counter) for a terminal launch
        error on a single request."""
        if isinstance(e, _ResNumericalFault):
            return (NumericalFault(str(e), kind=e.kind, member=e.member,
                                   max_abs=e.max_abs), "numerical_fault")
        if isinstance(e, (CheckpointMismatch, LaunchFailed)):
            return e, "launch_failed"
        return (LaunchFailed(f"launch failed: {type(e).__name__}: {e}"),
                "launch_failed")

    # --- compute (a launch slot's stream; possibly a worker thread) ---------
    def _stream(self, device: torch.device, slot: int):
        key = (device.index, slot)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device=device)
        return self._streams[key]

    def _prewarm_bucket(self, b: _Bucket) -> None:
        """``plan.prewarm`` over the bucket's batch classes (loads the
        kernel library and launches each size once), then one zero launch
        per batch class through :meth:`_run_batch` on the first slot, so
        the first real launch of a class there finds its staging buffer
        in place."""
        prob = b.plan.problem
        b.plan.prewarm(b.cfg.batch_classes)
        zeros = torch.zeros(prob.state_shape, dtype=prob.torch_dtype)
        aux = (torch.zeros(prob.shape, dtype=prob.torch_dtype)
               if prob.needs_aux else None)
        req = StencilRequest(prob, zeros, 1, aux=aux)
        for c in b.cfg.batch_classes:
            recs = [PendingRequest(seq=-1, request=req, submitted_at=0.0,
                                   expires_at=None, coeffs_sig=None,
                                   iters=1) for _ in range(c)]
            self._run_batch(b, recs, 0)

    def _run_batch(self, b: _Bucket, batch: List[PendingRequest],
                   slot: int):
        """One coalesced launch on slot ``slot``: ``(outs, faults, padded,
        rounds)``.  On a card it runs on the slot's stream."""
        fault_point(FP_LAUNCH, {"bucket": b.cfg.name, "batch": len(batch),
                                "seqs": tuple(r.seq for r in batch)})
        device = b.plan.device
        if device.type != "cuda":
            return self._compute(b, batch, slot)
        with torch.cuda.device(device), \
                torch.cuda.stream(self._stream(device, slot)):
            return self._compute(b, batch, slot)

    def _compute(self, b: _Bucket, batch: List[PendingRequest], slot: int):
        """Stage, pad to a batch class, advance by staged rounds, and bring
        each member back at its own iteration count.

        Bit-exactness: members are independent in a batched launch (no
        CTA's arithmetic depends on its member), so padding the batch by
        replicating the last real member changes no real member's result;
        and a staged advance (``run k1``, then ``k2 - k1``) computes every
        cell of every iteration as one ``run k2`` does — a super-step's
        compute region holds exactly its iterations' values, whichever
        super-step an iteration falls in."""
        if batch[0].request.checkpoint_key is not None:
            return self._run_checkpointed(b, batch[0])
        p = b.plan
        prob = p.problem
        padded = b.cfg.pad_to_class(len(batch))
        grids = b.staging.to_device(
            ("grid", slot), [r.request.grid for r in batch], padded,
            prob.state_shape)
        aux = None
        if prob.needs_aux:
            aux = b.staging.to_device(
                ("aux", slot), [r.request.aux for r in batch], padded,
                prob.shape)
        coeffs = batch[0].request.coeffs    # members share the resolved sig
        n = len(batch)
        stops = sorted({r.iters for r in batch})
        health = self.config.health
        outs, faults = [None] * n, [None] * n
        cur, prev = grids, 0
        for it in stops:
            cur = p.run_batch(cur, it - prev, coeffs, aux=aux)
            prev = it
            done = [i for i, r in enumerate(batch) if r.iters == it]
            found = health.faults_of(cur[:n],
                                     where=f"bucket {b.cfg.name!r}")
            if cur.device.type == "cuda":
                # one copy of the round's real members, then a sync
                host = torch.empty((n,) + tuple(cur.shape[1:]),
                                   dtype=cur.dtype, pin_memory=True)
                host.copy_(cur[:n], non_blocking=True)
                torch.cuda.current_stream().synchronize()
            else:
                host = cur[:n]
            for i in done:
                outs[i], faults[i] = host[i], found[i]
        return outs, faults, padded, len(stops)

    def _run_checkpointed(self, b: _Bucket, rec: PendingRequest):
        """Serving-side checkpointed execution: one stateful request,
        chunked through :func:`repro_torch.resilience.run_checkpointed`
        under ``<checkpoint_dir>/<checkpoint_key>``.  A crashed service
        resumes the same key from the last complete super-step on
        resubmission, bit-identically.  ``rounds`` reports the chunks
        run."""
        req = rec.request
        res = run_checkpointed(
            b.plan, req.grid, rec.iters, req.coeffs, aux=req.aux,
            checkpoint_every=req.checkpoint_every,
            checkpoint_dir=os.path.join(self.config.checkpoint_dir,
                                        req.checkpoint_key),
            health=self.config.health)
        return [res.grid.cpu()], [None], 1, max(1, res.chunks_run)

    # --- observability ------------------------------------------------------
    def snapshot(self) -> dict:
        """Metrics snapshot, extended with per-bucket configuration and
        live queue depth."""
        snap = self.metrics.snapshot()
        snap["buckets"] = {
            b.cfg.name: {
                "backend": b.cfg.run.backend,
                "device": str(b.cfg.run.device),
                "shape": list(b.cfg.problem.shape),
                "dtype": b.cfg.problem.dtype,
                "bc": b.cfg.problem.bc.token(),
                "max_batch": b.cfg.max_batch,
                "max_wait_ms": b.cfg.max_wait_ms,
                "queue_cap": b.cfg.queue_cap,
                "batch_classes": list(b.cfg.batch_classes),
                "depth": b.state.depth(),
                "last_batch_s": b.last_batch_s,
                "breaker": ("disabled" if b.breaker is None
                            else b.breaker.mode(self._clock())),
            } for b in self._buckets.values()
        }
        return snap

    @property
    def buckets(self) -> Dict[str, BucketConfig]:
        return {b.cfg.name: b.cfg for b in self._buckets.values()}


async def serve(config, *, prewarm: bool = True,
                clock=time.monotonic) -> StencilService:
    """Build and boot a :class:`StencilService` (plans built, kernels
    pre-warmed for every declared batch class, workers running)."""
    service = StencilService(config, clock=clock)
    await service.start(prewarm=prewarm)
    return service


async def from_config(spec, *, prewarm: bool = True,
                      clock=time.monotonic) -> StencilService:
    """Declarative boot: dict / JSON string / ``ServiceConfig`` -> running
    service."""
    return await serve(ServiceConfig.make(spec), prewarm=prewarm,
                       clock=clock)
