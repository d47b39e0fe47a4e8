"""The port's stencil service (``repro_torch.serve``) on the CPU, through
the ``hopper`` backend's plain version: ``tests/test_serving.py``'s cases
— the clock-free batcher, config parsing (and the refused reference
keys), ``bucket_key`` equal to ``repro``'s, coalescing, deadlines,
overload with retry-after, mixed-``iters`` rounds, batch-class padding,
drain, metrics — and the resilience ladder of ``tests/test_resilience.py``
(retry, bisection, quarantine, the breaker, checkpointed requests, one
transient fault at every registered point).  Every delivered grid equals
the port's ``plan.run`` of the request bit for bit, and ``repro``'s
service (backend ``reference``) on the same requests within
``repro.core.precision.tolerance``."""
import asyncio
import json
import time

import numpy as np
import pytest
import torch

import _torch_conformance  # noqa: F401 — one thread, as the other files
import repro.serve as jserve
import repro_torch.checkpoint  # noqa: F401 — registers the checkpoint points
from repro import api as japi
from repro import programs as jprograms
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import stencils
from repro_torch.resilience import (FaultPlan, FaultSpec, NumericalFault,
                                    active_plan, registered_points)
from repro_torch.serve import (BucketConfig, BucketState, DeadlineExceeded,
                               LaunchFailed, NoMatchingBucket,
                               PendingRequest, ServeError, ServiceClosed,
                               ServiceConfig, ServiceOverloaded,
                               StencilRequest, StencilService, bucket_key,
                               coeffs_signature, from_config, percentile,
                               serve)
from repro_torch.serve.config import REFUSED_RUN_KEYS

SHAPE = (12, 32)
RUN = {"backend": "hopper", "par_time": 2, "bsize": 16, "device": "cpu"}
FAST_RETRY = {"max_attempts": 2, "base_backoff_s": 0.001}


@pytest.fixture(autouse=True)
def no_leaked_plan():
    yield
    p = active_plan()
    if p is not None:
        p.uninstall()


def run_async(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def make_bucket(**kw) -> BucketConfig:
    spec = dict(problem={"stencil": "diffusion2d", "shape": list(SHAPE)},
                run=dict(RUN), max_batch=4, max_wait_ms=5.0, queue_cap=16)
    spec.update(kw)
    return BucketConfig(**spec)


def rec(seq, now=0.0, sig="a", iters=4, expires_at=None) -> PendingRequest:
    return PendingRequest(seq=seq, request=None, submitted_at=now,
                          expires_at=expires_at, coeffs_sig=sig, iters=iters)


def grids_for(n, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 2.0, shape).astype(np.float32)
            for _ in range(n)]


def grid_for(seed, shape=SHAPE):
    return grids_for(1, shape, seed)[0]


def assert_conserved(snap):
    assert snap["submitted"] == snap["completed"] \
        + snap["rejected_total"] + snap["failed_total"]
    assert snap["in_flight"] == 0


def _plan(problem=None):
    return plan(problem or StencilProblem("diffusion2d", SHAPE),
                RunConfig(**RUN))


# --- batcher core: deterministic-clock policy tests --------------------------

class TestBucketState:
    def test_window_arms_on_first_admit(self):
        bs = BucketState(make_bucket(max_wait_ms=10.0))
        assert bs.ready_at(now=0.0) is None
        assert bs.admit(rec(1), now=5.0)
        assert bs.ready_at(now=5.0) == pytest.approx(5.010)
        assert bs.admit(rec(2), now=5.008)
        assert bs.ready_at(now=5.008) == pytest.approx(5.010)
        assert not bs.ready(now=5.009)
        assert bs.ready(now=5.010)

    def test_full_batch_launches_early(self):
        bs = BucketState(make_bucket(max_batch=3, max_wait_ms=1000.0))
        for i in range(2):
            bs.admit(rec(i), now=0.0)
        assert not bs.ready(now=0.0)
        bs.admit(rec(2), now=0.0)
        assert bs.ready(now=0.0)
        batch, expired = bs.take_batch(now=0.0)
        assert [r.seq for r in batch] == [0, 1, 2] and not expired
        assert bs.ready_at(now=0.0) is None

    def test_draining_ignores_window(self):
        bs = BucketState(make_bucket(max_wait_ms=1000.0))
        bs.admit(rec(1), now=0.0)
        assert not bs.ready(now=0.0)
        assert bs.ready(now=0.0, draining=True)

    def test_queue_cap_backpressure(self):
        bs = BucketState(make_bucket(queue_cap=3, max_batch=8))
        assert all(bs.admit(rec(i), now=0.0) for i in range(3))
        assert not bs.admit(rec(3), now=0.0)
        assert bs.depth() == 3

    def test_coeffs_sig_subgroups(self):
        bs = BucketState(make_bucket(max_batch=8))
        for i, sig in enumerate("aabab"):
            bs.admit(rec(i, sig=sig), now=0.0)
        batch, _ = bs.take_batch(now=7.0)
        assert [r.seq for r in batch] == [0, 1, 3]
        assert [r.seq for r in bs.pending] == [2, 4]
        assert bs.ready_at(now=7.0) == pytest.approx(7.0 + 5e-3)
        batch2, _ = bs.take_batch(now=7.1)
        assert [r.seq for r in batch2] == [2, 4]

    def test_max_rounds_caps_distinct_iters(self):
        bs = BucketState(make_bucket(max_batch=8, max_rounds=2))
        for i, iters in enumerate([4, 8, 4, 2, 8]):
            bs.admit(rec(i, iters=iters), now=0.0)
        batch, _ = bs.take_batch(now=0.0)
        assert [r.seq for r in batch] == [0, 1, 2, 4]
        assert [r.seq for r in bs.pending] == [3]

    def test_deadline_sweep_and_breaker_limit(self):
        bs = BucketState(make_bucket(max_batch=8))
        bs.admit(rec(0, expires_at=1.0), now=0.0)
        bs.admit(rec(1), now=0.0)
        bs.admit(rec(2, expires_at=9.0), now=0.0)
        batch, expired = bs.take_batch(now=2.0, limit=1)
        assert [r.seq for r in expired] == [0]
        assert [r.seq for r in batch] == [1]


# --- config, requests, bucket keys -------------------------------------------

class TestConfig:
    def test_same_json_as_reference(self):
        """The reference's service JSON with the port's run keys parses to
        the same buckets, names and batch classes."""
        d = {"buckets": [{"problem": {"stencil": "diffusion2d",
                                      "shape": list(SHAPE)},
                          "run": dict(RUN), "max_batch": 4},
                         {"problem": {"stencil": "hotspot2d",
                                      "shape": list(SHAPE),
                                      "boundary": "reflect"},
                          "run": dict(RUN), "max_batch": 6,
                          "batch_classes": [2, 6]}],
             "retry": {"max_attempts": 2}, "breaker": False,
             "health": {"max_abs": 1e3}}
        jd = json.loads(json.dumps(d))
        for b in jd["buckets"]:
            b["run"] = {"backend": "reference"}
        want = jserve.ServiceConfig.make(json.dumps(jd))
        for spec in (d, json.dumps(d)):
            cfg = ServiceConfig.make(spec)
            assert [b.name for b in cfg.buckets] == \
                [b.name for b in want.buckets]
            assert [b.batch_classes for b in cfg.buckets] == \
                [b.batch_classes for b in want.buckets]
            assert [b.key for b in cfg.buckets] == \
                [b.key for b in want.buckets]
            assert cfg.retry.max_attempts == 2 and cfg.breaker is None
            assert cfg.health.max_abs == 1e3
            assert cfg.buckets[0].run.device == torch.device("cpu")
        assert ServiceConfig.make(cfg) is cfg
        assert BucketConfig(problem=StencilProblem("diffusion2d", SHAPE)
                            ).run.device == torch.device("cuda")

    @pytest.mark.parametrize("key", sorted(REFUSED_RUN_KEYS))
    def test_reference_run_keys_are_refused_by_name(self, key):
        with pytest.raises(ValueError, match=f"'{key}' is refused"):
            make_bucket(run=dict(RUN, **{key: True}))

    def test_validation(self):
        with pytest.raises(ValueError, match="pad up to"):
            make_bucket(max_batch=8, batch_classes=(1, 2, 4))
        b = make_bucket(max_batch=6, batch_classes=(2, 6))
        assert b.pad_to_class(1) == 2 and b.pad_to_class(3) == 6
        with pytest.raises(ValueError, match="serve the same"):
            ServiceConfig(buckets=(make_bucket(), make_bucket(max_batch=2)))
        with pytest.raises(ValueError, match="unknown stencil"):
            make_bucket(problem={"stencil": "nope", "shape": [8, 8]})
        with pytest.raises(ValueError, match="at least one bucket"):
            ServiceConfig(buckets=())
        with pytest.raises(ValueError, match="max_wait_ms"):
            make_bucket(max_wait_ms=-1)
        with pytest.raises(ValueError, match="queue_cap"):
            make_bucket(queue_cap=0)


def _wave(S, P, st):
    return P((S(st.make_star(2, 1), name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _chain(S, P, st):
    return [S(st.make_star(2, 1), coeffs={"c0": 0.7}), S("diffusion2d")]


@pytest.mark.parametrize("spec", [
    ("diffusion2d", "clamp", "float32"), ("hotspot2d", "reflect", "float32"),
    ("diffusion2d", ("clamp", "periodic"), "bfloat16"),
    ("hotspot3d", "clamp", "float32"), (_chain, "constant:1.5", "float32"),
    (_wave, "periodic", "float32")],
    ids=["diffusion2d", "hotspot2d-reflect", "diffusion2d-mixed-bf16",
         "hotspot3d", "chain-constant", "wave-periodic"])
def test_bucket_key_equals_reference(spec):
    """Same fingerprint, state shape, boundary token and dtype."""
    st, bc, dtype = spec
    dims = (7, 19, 17) if st == "hotspot3d" else SHAPE
    mine = (st if isinstance(st, str) else
            st(StencilStage, StencilProgram, stencils))
    want = (st if isinstance(st, str) else
            st(jprograms.StencilStage, jprograms.StencilProgram, jstencils))
    assert bucket_key(StencilProblem(mine, dims, boundary=bc, dtype=dtype)) \
        == jserve.bucket_key(japi.StencilProblem(want, dims, boundary=bc,
                                                 dtype=dtype))


class TestRequest:
    def test_normalizes_name_and_dtype(self):
        r = StencilRequest("diffusion2d", np.zeros(SHAPE, np.float32), 3)
        assert r.bucket_key == bucket_key(StencilProblem("diffusion2d",
                                                         SHAPE))
        r16 = StencilRequest("diffusion2d", torch.zeros(SHAPE).bfloat16(), 3)
        assert r16.problem.dtype == "bfloat16"

    def test_rejects_bad_fields(self):
        g = np.zeros(SHAPE, np.float32)
        with pytest.raises(ValueError, match="iters"):
            StencilRequest("diffusion2d", g, iters=0)
        with pytest.raises(ValueError, match="deadline_s"):
            StencilRequest("diffusion2d", g, iters=1, deadline_s=0)
        with pytest.raises(ValueError, match="state"):
            StencilRequest(StencilProblem("diffusion2d", (8, 8)), g, iters=1)
        with pytest.raises(ValueError, match="needs an aux"):
            StencilRequest("hotspot2d", g, iters=1)
        with pytest.raises(ValueError, match="takes no aux"):
            StencilRequest("diffusion2d", g, iters=1, aux=g)
        with pytest.raises(ValueError, match="checkpoint_every"):
            StencilRequest("diffusion2d", g, 1, checkpoint_key="k")
        with pytest.raises(ValueError, match="path-component"):
            StencilRequest("diffusion2d", g, 1, checkpoint_key="a/b",
                           checkpoint_every=2)

    def test_coeffs_signature_groups(self):
        prob = StencilProblem("diffusion2d", SHAPE)
        assert coeffs_signature(prob, None) == coeffs_signature(prob, {})
        assert (coeffs_signature(prob, {"cc": 0.25})
                != coeffs_signature(prob, None))
        with pytest.raises(ValueError, match="unknown coefficients"):
            coeffs_signature(prob, {"zz": 1.0})


# --- the live service --------------------------------------------------------

async def _gather_service(cfg, reqs, prewarm=False):
    svc = await serve(cfg, prewarm=prewarm)
    futs = [svc.submit_nowait(r) for r in reqs]
    results = await asyncio.gather(*futs, return_exceptions=True)
    snap = svc.snapshot()
    await svc.stop()
    return results, snap, svc.snapshot()


class TestService:
    def test_autotune_bucket_boots_off_the_loop_and_serves(self, tmp_path,
                                                          monkeypatch):
        """A bucket whose ``run`` has ``"autotune": True`` (the reference's
        default bucket) or ``"measure"`` boots and serves on the CPU: its
        plan is built off the event loop (``asyncio.to_thread``), and every
        delivered grid equals the tuned plan's ``run`` bit for bit."""
        import threading

        from repro_torch.serve import service as service_mod
        threads = []
        real = service_mod.make_plan

        def spy(problem, run):
            threads.append(threading.current_thread())
            return real(problem, run)
        monkeypatch.setattr(service_mod, "make_plan", spy)
        runs = [{"backend": "hopper", "device": "cpu", "autotune": True},
                {"backend": "hopper", "device": "cpu", "autotune": "measure",
                 "tune_top_k": 2, "tune_repeats": 1,
                 "cache": str(tmp_path / "s.json")}]
        shapes = [SHAPE, (16, 40)]
        cfg = ServiceConfig(buckets=tuple(
            make_bucket(problem={"stencil": "diffusion2d",
                                 "shape": list(shape)}, run=run)
            for shape, run in zip(shapes, runs)))
        assert [b.run.autotune for b in cfg.buckets] == ["model", "measure"]
        gs = [grid_for(i, shape) for i, shape in enumerate(shapes * 2)]
        reqs = [StencilRequest(StencilProblem("diffusion2d", g.shape), g,
                               iters=5) for g in gs]

        async def main():
            loop_thread = threading.current_thread()
            svc = await serve(cfg, prewarm=False)
            plans = {b.cfg.name: b.plan for b in svc._buckets.values()}
            out = await asyncio.gather(*[svc.submit_nowait(r)
                                         for r in reqs])
            await svc.stop()
            return loop_thread, plans, out
        loop_thread, plans, out = run_async(main())
        assert threads and all(t is not loop_thread for t in threads)
        for p in plans.values():
            assert p.geometry is not None and p.candidates
        by_shape = {p.problem.shape: p for p in plans.values()}
        for r, got in zip(reqs, out):
            assert torch.equal(got.grid,
                               by_shape[r.problem.shape].run(r.grid, 5))

    def test_results_equal_plan_run_and_reference_service(self):
        """Clamp, a periodic mix, reflect and constant buckets (and a
        Hotspot bucket with per-request aux and a bf16 bucket): every
        delivered grid equals the port's ``plan.run`` bit for bit, and
        ``repro``'s service (backend ``reference``) on the same requests
        within tolerance."""
        bcs = ["clamp", ("clamp", "periodic"), "reflect", "constant:1.5"]
        specs = [("diffusion2d", bc, "float32") for bc in bcs] + [
            ("hotspot2d", "clamp", "float32"),
            ("diffusion2d", "clamp", "bfloat16")]
        gs = grids_for(2 * len(specs))
        auxs = grids_for(2 * len(specs), seed=9)

        def problems(mod):
            return [mod.StencilProblem(s, SHAPE, boundary=bc, dtype=dt)
                    for s, bc, dt in specs]

        def requests(mod, probs, bf16):
            out = []
            for i, g in enumerate(gs):
                prob = probs[i % len(specs)]
                aux = (auxs[i] * 0.05) if prob.needs_aux else None
                if prob.dtype == "bfloat16":
                    g = bf16(g)
                out.append(mod.StencilRequest(prob, g, iters=3 + (i % 2),
                                              aux=aux))
            return out

        mine = problems(type("m", (), {"StencilProblem": StencilProblem}))
        reqs = requests(type("m", (), {"StencilRequest": StencilRequest}),
                        mine, lambda g: torch.from_numpy(g).bfloat16())
        cfg = ServiceConfig(buckets=tuple(
            make_bucket(problem=p, max_wait_ms=10.0) for p in mine))
        results, snap, _ = run_async(_gather_service(cfg, reqs))
        import jax.numpy as jnp
        jprobs = problems(japi)
        jreqs = requests(jserve, jprobs,
                         lambda g: jnp.asarray(g, jnp.bfloat16))
        jcfg = jserve.ServiceConfig(buckets=tuple(
            jserve.BucketConfig(problem=p, run={"backend": "reference"},
                                max_batch=4, max_wait_ms=10.0)
            for p in jprobs))

        async def jmain():
            svc = await jserve.serve(jcfg, prewarm=False)
            out = await asyncio.gather(*[svc.submit_nowait(r)
                                         for r in jreqs])
            await svc.stop()
            return out
        jresults = run_async(jmain())
        assert snap["completed"] == len(reqs) and snap["failed_total"] == 0
        for r, res, jres in zip(reqs, results, jresults):
            assert isinstance(res.grid, torch.Tensor)
            assert res.grid.dtype == r.problem.torch_dtype
            want = _plan(r.problem).run(r.grid, r.iters, aux=r.aux)
            assert torch.equal(res.grid, want)
            np.testing.assert_allclose(
                res.grid.double().numpy(),
                np.asarray(jres.grid.astype(np.float32), np.float64),
                **jprecision.tolerance(
                    r.problem.dtype, r.iters,
                    scale=100 if r.problem.needs_aux else None))

    def test_distributed_bucket_equals_plan_run(self):
        """A ``"distributed"`` bucket on a 2-shard CPU mesh (the mesh and
        ``axis_map`` keys the port once refused) serves requests, coalesced
        into ``run_batch`` rounds, each equal to ``plan().run()`` of the
        same request on the same config bit for bit."""
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((2,), ("d",), [torch.device("cpu")] * 2)
        run = {"backend": "distributed", "par_time": 2, "bsize": 16,
               "device": "cpu", "mesh": mesh, "axis_map": [None, "d"]}
        bucket = make_bucket(run=run, max_wait_ms=10.0)
        assert bucket.run.axis_map == (None, ("d",))
        gs = grids_for(5, seed=3)
        reqs = [StencilRequest("diffusion2d", g, 3 + i % 2)
                for i, g in enumerate(gs)]
        results, snap, _ = run_async(_gather_service(
            ServiceConfig(buckets=(bucket,)), reqs))
        assert snap["completed"] == len(reqs) and snap["failed_total"] == 0
        p = plan(StencilProblem("diffusion2d", SHAPE), RunConfig(**run))
        for r, res in zip(reqs, results):
            assert torch.equal(res.grid, p.run(r.grid, r.iters))

    def test_unmatched_dtype_and_shape_rejected(self):
        async def main():
            svc = await serve(ServiceConfig(buckets=(make_bucket(),)),
                              prewarm=False)
            with pytest.raises(NoMatchingBucket, match="declared"):
                svc.submit_nowait(StencilRequest(
                    "diffusion2d", torch.ones(SHAPE).bfloat16(), 2))
            with pytest.raises(NoMatchingBucket):
                svc.submit_nowait(StencilRequest(
                    "diffusion2d", np.zeros((8, 8), np.float32), 2))
            await svc.stop()
            return svc.snapshot()
        snap = run_async(main())
        assert snap["rejected"]["no_bucket"] == 2
        assert_conserved(snap)

    def test_staged_advance_mixed_iters(self):
        gs = grids_for(4)
        iters = [2, 6, 2, 5]
        reqs = [StencilRequest("diffusion2d", g, it)
                for g, it in zip(gs, iters)]
        cfg = ServiceConfig(buckets=(make_bucket(max_wait_ms=50.0),))
        results, snap, _ = run_async(_gather_service(cfg, reqs))
        assert snap["batches"] == 1 and snap["rounds"] == 3
        p = _plan()
        for r, res in zip(reqs, results):
            assert res.rounds == 3 and res.batch_size == 4
            assert torch.equal(res.grid, p.run(r.grid, r.iters))

    def test_batch_padding_to_class_is_exact(self):
        gs = grids_for(3)
        reqs = [StencilRequest("diffusion2d", g, 4) for g in gs]
        cfg = ServiceConfig(buckets=(make_bucket(max_wait_ms=20.0),))
        results, snap, _ = run_async(_gather_service(cfg, reqs))
        p = _plan()
        for r, res in zip(reqs, results):
            assert res.batch_fill == pytest.approx(3 / 4)
            assert torch.equal(res.grid, p.run(r.grid, 4))

    def test_aux_and_coeffs_subgrouping(self):
        gs, auxs = grids_for(3), grids_for(3, seed=7)
        coeffs = [None, None, {"sdc": 0.5}]
        reqs = [StencilRequest("hotspot2d", g, 3, coeffs=c, aux=a * 0.05)
                for g, a, c in zip(gs, auxs, coeffs)]
        cfg = ServiceConfig(buckets=(make_bucket(
            problem={"stencil": "hotspot2d", "shape": list(SHAPE)},
            max_wait_ms=20.0),))
        results, snap, _ = run_async(_gather_service(cfg, reqs))
        assert snap["batches"] == 2
        p = _plan(StencilProblem("hotspot2d", SHAPE))
        for r, res in zip(reqs, results):
            assert torch.equal(res.grid, p.run(r.grid, 3, r.coeffs,
                                               aux=r.aux))

    def test_queue_full_backpressure_and_drain(self):
        async def main():
            svc = await serve(ServiceConfig(buckets=(
                make_bucket(queue_cap=3, max_batch=8,
                            max_wait_ms=60_000.0),)), prewarm=False)
            gs = grids_for(4)
            futs = [svc.submit_nowait(StencilRequest("diffusion2d", g, 2))
                    for g in gs[:3]]
            with pytest.raises(ServiceOverloaded) as ei:
                svc.submit_nowait(StencilRequest("diffusion2d", gs[3], 2))
            stop = asyncio.create_task(svc.stop())   # drain ignores window
            results = await asyncio.gather(*futs)
            await stop
            with pytest.raises(ServiceClosed):
                svc.submit_nowait(StencilRequest("diffusion2d", gs[0], 2))
            return ei.value, results, svc.snapshot()
        err, results, snap = run_async(main())
        assert err.retry_after_s >= 60.0
        assert len(results) == 3 and snap["completed"] == 3
        assert snap["rejected"]["overload"] == 1
        assert snap["rejected"]["closed"] == 1
        assert_conserved(snap)

    def test_deadline_expiry(self):
        async def main():
            svc = await serve(ServiceConfig(buckets=(
                make_bucket(max_batch=8, max_wait_ms=80.0),)), prewarm=False)
            g = grid_for(0)
            fut = svc.submit_nowait(StencilRequest(
                "diffusion2d", g, 2, deadline_s=1e-3))
            ok = svc.submit_nowait(StencilRequest("diffusion2d", g, 2))
            with pytest.raises(DeadlineExceeded):
                await fut
            res = await ok
            await svc.stop()
            return res, svc.snapshot()
        res, snap = run_async(main())
        assert res.batch_size == 1
        assert snap["rejected"]["deadline"] == 1
        assert_conserved(snap)

    def test_prewarm_metrics_snapshot_and_json(self, tmp_path):
        async def main():
            svc = await from_config({"buckets": [
                {"problem": {"stencil": "diffusion2d", "shape": list(SHAPE)},
                 "run": dict(RUN), "max_batch": 4, "max_wait_ms": 10.0}]})
            futs = [svc.submit_nowait(StencilRequest("diffusion2d", g, 2))
                    for g in grids_for(4)]
            await asyncio.gather(*futs)
            path = svc.metrics.write_json(tmp_path / "m" / "snap.json")
            snap = svc.snapshot()
            await svc.stop()
            return path, snap
        path, snap = run_async(main())
        loaded = json.loads(path.read_text())
        for k in ("submitted", "completed", "rejected", "latency_ms",
                  "batch_fill", "cells", "queue_depth", "failed",
                  "failed_total", "quarantined", "retries", "breaker",
                  "in_flight", "prewarm_s"):
            assert k in loaded
        assert loaded["latency_ms"]["p50"] <= loaded["latency_ms"]["p99"]
        assert snap["cells"] == 4 * 2 * SHAPE[0] * SHAPE[1]
        assert all(s > 0 for s in snap["prewarm_s"].values())
        b = snap["buckets"]["diffusion2d@12x32"]
        assert b["batch_classes"] == [1, 2, 4] and b["depth"] == 0
        assert b["device"] == "cpu"

    def test_open_loop_seeded_integration(self):
        """Seeded open-loop arrivals: every submit resolves (a result or a
        typed rejection), served results equal per-request runs bit for
        bit, overload rejections carry retry-after hints."""
        rng = np.random.default_rng(42)
        n = 24
        gaps = rng.exponential(2e-3, n)
        iters = rng.choice([2, 4], n)

        async def main():
            svc = await serve(ServiceConfig(buckets=(
                make_bucket(max_batch=4, max_wait_ms=2.0, queue_cap=6),)),
                prewarm=False)
            gs = grids_for(n)
            outcomes = []

            async def one(i):
                try:
                    fut = svc.submit_nowait(StencilRequest(
                        "diffusion2d", gs[i], int(iters[i])))
                except ServiceOverloaded as e:
                    outcomes.append(("rejected", i, e.retry_after_s))
                    return
                outcomes.append(("served", i, await fut))

            tasks = []
            for i in range(n):
                await asyncio.sleep(float(gaps[i]))
                tasks.append(asyncio.create_task(one(i)))
            await asyncio.gather(*tasks)
            await svc.stop()
            return gs, outcomes, svc.snapshot()

        gs, outcomes, snap = run_async(main())
        assert len(outcomes) == n
        served = [o for o in outcomes if o[0] == "served"]
        rejected = [o for o in outcomes if o[0] == "rejected"]
        assert snap["completed"] == len(served)
        assert snap["rejected"]["overload"] == len(rejected)
        assert all(r[2] > 0 for r in rejected)
        p = _plan()
        for _, i, res in served:
            assert torch.equal(res.grid, p.run(gs[i], int(iters[i])))
        assert_conserved(snap)

    def test_concurrent_offloaded_launches(self):
        """Two launch slots in worker threads: results stay equal to
        ``plan.run`` bit for bit."""
        gs = grids_for(8)
        reqs = [StencilRequest("diffusion2d", g, 2 + i % 3)
                for i, g in enumerate(gs)]
        cfg = ServiceConfig(buckets=(make_bucket(max_batch=2,
                                                 max_wait_ms=1.0),),
                            max_concurrent_batches=2)
        results, snap, _ = run_async(_gather_service(cfg, reqs))
        p = _plan()
        for r, res in zip(reqs, results):
            assert torch.equal(res.grid, p.run(r.grid, r.iters))
        assert snap["batches"] >= 4


# --- the resilience ladder ---------------------------------------------------

def service_config(**kw):
    spec = dict(buckets=[dict(problem={"stencil": "diffusion2d",
                                       "shape": list(SHAPE)},
                              run=dict(RUN), max_batch=4, max_wait_ms=1.0,
                              queue_cap=16)],
                retry=dict(FAST_RETRY))
    spec.update(kw)
    return ServiceConfig.make(spec)


async def run_workload(svc, n=6, iters=(2, 4), seed0=0):
    reqs = [StencilRequest("diffusion2d", grid_for(seed0 + i),
                           iters[i % len(iters)]) for i in range(n)]
    futs = [svc.submit_nowait(r) for r in reqs]
    return await asyncio.gather(*futs, return_exceptions=True)


class TestResilience:
    def test_nan_member_is_quarantined_neighbors_bit_identical(self):
        async def main():
            svc = await StencilService(service_config()).start(prewarm=False)
            clean = await run_workload(svc, n=3, iters=(4,))
            fplan = FaultPlan([FaultSpec("backend.execute_batch.result",
                                         action="nan", nth=1, member=1)])
            with fplan.active():
                res = await run_workload(svc, n=3, iters=(4,))
            await svc.stop()
            return clean, res, svc.snapshot()
        clean, res, snap = run_async(main())
        assert isinstance(res[1], NumericalFault)
        assert isinstance(res[1], ServeError)
        assert res[1].kind == "nan" and res[1].member == 1
        assert res[0].batch_size == 3
        for i in (0, 2):
            assert torch.equal(res[i].grid, clean[i].grid)
        assert snap["failed"]["numerical_fault"] == 1
        assert snap["quarantined"] == 1
        assert_conserved(snap)

    def test_bisection_isolates_the_poison_request(self):
        async def main():
            svc = await StencilService(service_config()).start(prewarm=False)
            fplan = FaultPlan([FaultSpec(
                "serve.launch", max_fires=None,
                match=lambda ctx: 3 in ctx.get("seqs", ()))])
            with fplan.active():
                res = await run_workload(svc, n=4, iters=(4,))
            await svc.stop()
            return res, svc.snapshot()
        res, snap = run_async(main())
        assert isinstance(res[2], LaunchFailed), res
        assert res[2].attempts >= 2
        assert all(not isinstance(r, Exception)
                   for i, r in enumerate(res) if i != 2)
        assert snap["failed"]["launch_failed"] == 1
        assert snap["retries"] >= 1
        assert_conserved(snap)

    def test_transient_fault_is_retried_away(self):
        async def main():
            svc = await StencilService(service_config()).start(prewarm=False)
            with FaultPlan([FaultSpec("backend.execute_batch",
                                      nth=1)]).active():
                res = await run_workload(svc, n=3, iters=(4,))
            await svc.stop()
            return res, svc.snapshot()
        res, snap = run_async(main())
        assert all(not isinstance(r, Exception) for r in res)
        assert snap["retries"] >= 1 and snap["failed_total"] == 0
        p = _plan()
        for i, r in enumerate(res):
            assert torch.equal(r.grid, p.run(grid_for(i), 4))
        assert_conserved(snap)

    def test_breaker_degrades_opens_and_recovers(self):
        offset = [0.0]

        def clock():
            return time.monotonic() + offset[0]

        async def main():
            cfg = service_config(
                retry={"max_attempts": 1},
                breaker={"fail_threshold": 1, "open_threshold": 1,
                         "recovery_successes": 1, "open_cooldown_s": 30.0})
            svc = await StencilService(cfg, clock=clock).start(prewarm=False)
            name = svc.config.buckets[0].name
            modes = []
            with FaultPlan([FaultSpec("serve.launch", p=1.0,
                                      max_fires=None)]).active():
                r1 = await asyncio.gather(svc.submit_nowait(
                    StencilRequest("diffusion2d", grid_for(0), 2)),
                    return_exceptions=True)
                modes.append(svc.snapshot()["breaker"][name])
                r2 = await asyncio.gather(svc.submit_nowait(
                    StencilRequest("diffusion2d", grid_for(1), 2)),
                    return_exceptions=True)
                modes.append(svc.snapshot()["breaker"][name])
                with pytest.raises(ServiceOverloaded) as ei:
                    svc.submit_nowait(
                        StencilRequest("diffusion2d", grid_for(2), 2))
            offset[0] += 31.0
            ok = await svc.submit(
                StencilRequest("diffusion2d", grid_for(3), 2))
            modes.append(svc.snapshot()["breaker"][name])
            await svc.stop()
            return r1, r2, ei.value, ok, modes, svc.snapshot()
        r1, r2, err, ok, modes, snap = run_async(main())
        assert isinstance(r1[0], LaunchFailed)
        assert isinstance(r2[0], LaunchFailed)
        assert err.retry_after_s > 0
        assert modes == ["degraded", "open", "closed"]
        assert ok.iters == 2 and snap["rejected"]["breaker"] == 1
        assert_conserved(snap)

    def test_checkpointed_request_survives_a_failed_launch(self, tmp_path):
        """A checkpointed request whose launch dies after its first chunk
        (every later save fails; the retries resume and die again) fails
        with ``LaunchFailed``; resubmitted with the same key, it resumes
        and ends bit for bit as an uncheckpointed run."""
        ckroot = str(tmp_path / "serve-ck")

        async def main():
            svc = await StencilService(service_config(
                checkpoint_dir=ckroot)).start(prewarm=False)
            g = grid_for(0)
            req = dict(problem="diffusion2d", grid=g, iters=8,
                       checkpoint_key="job-1", checkpoint_every=2)
            with FaultPlan([FaultSpec(
                    "checkpoint.save", p=1.0, max_fires=None,
                    match=lambda ctx: ctx["step"] > 2)]).active():
                res1 = await asyncio.gather(
                    svc.submit_nowait(StencilRequest(**req)),
                    return_exceptions=True)
            res2 = await svc.submit(StencilRequest(**req))
            await svc.stop()
            return g, res1, res2, svc.snapshot()
        g, res1, res2, snap = run_async(main())
        assert isinstance(res1[0], LaunchFailed)
        assert torch.equal(res2.grid, _plan().run(g, 8))
        assert res2.rounds == 3            # resumed at 2: chunks 4, 6, 8
        assert_conserved(snap)

    def test_checkpointed_request_requires_configured_dir(self):
        async def main():
            svc = await StencilService(service_config()).start(prewarm=False)
            with pytest.raises(NoMatchingBucket, match="checkpoint_dir"):
                svc.submit_nowait(StencilRequest(
                    "diffusion2d", grid_for(0), 4,
                    checkpoint_key="k", checkpoint_every=2))
            await svc.stop()
            return svc.snapshot()
        assert_conserved(run_async(main()))


#: every injection point the port registers (spelled out: a list built at
#: import time would depend on which modules the worker imported first);
#: ``distributed.exchange`` registers with ``repro_torch.api``, as in the
#: reference, and never fires on this workload's ``hopper`` bucket
CHAOS_POINTS = ("backend.execute", "backend.execute.result",
                "backend.execute_batch", "backend.execute_batch.result",
                "checkpoint.restore", "checkpoint.save",
                "distributed.exchange", "schedule_cache.get",
                "schedule_cache.put", "serve.launch")


def test_chaos_points_are_the_registered_points():
    assert set(CHAOS_POINTS) == set(registered_points())


@pytest.mark.parametrize("point", CHAOS_POINTS)
def test_chaos_matrix_never_hangs_never_drops(point, tmp_path):
    """One transient raise at every registered point under a live workload
    with a checkpointed request: every request is answered (a result or a
    typed serve error) and the books balance."""
    async def main():
        cfg = service_config(checkpoint_dir=str(tmp_path / "ck"))
        svc = await StencilService(cfg).start(prewarm=False)
        with FaultPlan([FaultSpec(point, nth=1)]).active():
            res = await run_workload(svc, n=5, iters=(2, 4))
            fut = svc.submit_nowait(StencilRequest(
                "diffusion2d", grid_for(9), 4, checkpoint_key="chaos",
                checkpoint_every=2))
            res.extend(await asyncio.gather(fut, return_exceptions=True))
        await svc.stop()
        return res, svc.snapshot()
    res, snap = run_async(main())
    for r in res:
        assert not isinstance(r, Exception) or isinstance(r, ServeError), r
    assert_conserved(snap)


def test_percentile_nearest_rank():
    assert percentile([], 50) is None
    assert percentile([3.0], 99) == 3.0
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50, abs=1)
    assert percentile(xs, 0) == 1 and percentile(xs, 100) == 100
