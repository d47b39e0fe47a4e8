"""The port's resilience layer against ``repro``'s: ``HealthPolicy``
(reduced on the device, one host transfer a batch) gives the reference's
verdicts, kinds, members and messages on the same grids; ``RetryPolicy``
and ``CircuitBreaker`` give the same backoff sequences and mode
transitions on the same event and clock sequences; ``run_checkpointed``
resumes bit for bit, refuses a foreign directory, never saves a NaN'd
grid and keeps ``keep`` steps; and the port registers the reference's
fault points for backends, serving and checkpoints."""
import dataclasses
import os
import random
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_conformance  # noqa: F401 — one thread, as the other files
import repro.api  # noqa: F401 — registers the backend fault points
import repro.checkpoint  # noqa: F401 — registers the checkpoint points
import repro.serve  # noqa: F401 — registers serve.launch
from repro import resilience as jres
from repro_torch import resilience as res
from repro_torch import serve  # noqa: F401 — registers serve.launch
from repro_torch.api import RunConfig, StencilProblem, plan
from repro_torch.checkpoint import complete_steps
from repro_torch.resilience import (CheckpointMismatch, FaultPlan, FaultSpec,
                                    HealthPolicy, NumericalFault,
                                    run_checkpointed)

SHAPE = (12, 32)


@pytest.fixture(autouse=True)
def no_leaked_plan():
    yield
    for mod in (res, jres):
        p = mod.active_plan()
        if p is not None:
            p.uninstall()


def _grids(seed=0):
    """Named (4, 5, 6) float32 grids: healthy, one NaN, one Inf, a blowup,
    NaN and Inf together, all-NaN."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-2.0, 2.0, (4, 5, 6)).astype(np.float32)
    cases = {"healthy": g.copy()}
    for name, value in (("nan", np.nan), ("inf", np.inf), ("ninf", -np.inf),
                        ("blowup", 1e6), ("nblowup", -3e5)):
        x = g.copy()
        x[1, 2, 3] = value
        cases[name] = x
    both = g.copy()
    both[0, 0, 0], both[3, 4, 5] = np.inf, np.nan
    cases["nan_and_inf"] = both
    cases["all_nan"] = np.full_like(g, np.nan)
    return cases


def _same(mine, want):
    if want is None:
        assert mine is None
        return
    assert isinstance(mine, NumericalFault) and isinstance(mine,
                                                           res.ResilienceError)
    assert (mine.kind, mine.member, str(mine)) == (want.kind, want.member,
                                                   str(want))
    if want.max_abs is None:
        assert mine.max_abs is None
    else:
        assert mine.max_abs == pytest.approx(want.max_abs, rel=1e-6)


POLICIES = [dict(), dict(max_abs=10.0), dict(check_nonfinite=False,
                                             max_abs=10.0),
            dict(enabled=False)]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: repr(p))
@pytest.mark.parametrize("case", sorted(_grids()))
def test_fault_of_matches_reference(case, policy):
    g = _grids()[case]
    for member, where in ((None, ""), (5, "iteration 8")):
        _same(HealthPolicy(**policy).fault_of(torch.from_numpy(g),
                                              member=member, where=where),
              jres.HealthPolicy(**policy).fault_of(g, member=member,
                                                   where=where))


def test_bf16_fault_of_and_batch_members_match_reference():
    """bf16 grids, and a batch checked in one call: each member's verdict
    and member index as the reference gives them one grid at a time."""
    g = np.ones((4,), np.float32)
    assert HealthPolicy().fault_of(torch.from_numpy(g).bfloat16()) is None
    g[2] = np.nan
    _same(HealthPolicy().fault_of(torch.from_numpy(g).bfloat16(), member=5),
          jres.HealthPolicy().fault_of(g.astype(ml_dtypes.bfloat16),
                                       member=5))
    cases = _grids(1)
    names = sorted(cases)
    batch = torch.from_numpy(np.stack([cases[n] for n in names]))
    for dtype in (torch.float32, torch.bfloat16):
        pol = HealthPolicy(max_abs=100.0)
        got = pol.faults_of(batch.to(dtype), where="bucket 'b'")
        for i, (name, fault) in enumerate(zip(names, got)):
            x = batch[i].to(dtype)
            ref = (x.float().numpy() if dtype == torch.float32 else
                   x.float().numpy().astype(ml_dtypes.bfloat16))
            _same(fault, jres.HealthPolicy(max_abs=100.0).fault_of(
                ref, member=i, where="bucket 'b'"))


def test_health_check_and_make():
    with pytest.raises(NumericalFault):
        HealthPolicy().check(torch.tensor([np.inf]))
    HealthPolicy.make(False).check(torch.tensor([np.nan]))    # no raise
    for spec in (None, True, False, {"max_abs": 3.0}):
        assert (dataclasses.astuple(HealthPolicy.make(spec))
                == dataclasses.astuple(jres.HealthPolicy.make(spec)))
    with pytest.raises(ValueError, match="health spec"):
        HealthPolicy.make(3)


@pytest.mark.parametrize("policy", [
    dict(), dict(max_attempts=5, base_backoff_s=0.1, max_backoff_s=0.35),
    dict(max_attempts=8, base_backoff_s=0.001, max_backoff_s=1.0)])
def test_retry_policy_matches_reference(policy):
    mine, want = res.RetryPolicy(**policy), jres.RetryPolicy(**policy)
    assert [mine.backoff_s(k) for k in range(0, 12)] == \
        [want.backoff_s(k) for k in range(0, 12)]
    assert res.RetryPolicy.make(False).max_attempts == \
        jres.RetryPolicy.make(False).max_attempts == 1
    for bad in (dict(max_attempts=0), dict(base_backoff_s=-1)):
        with pytest.raises(ValueError):
            res.RetryPolicy(**bad)


@pytest.mark.parametrize("seed", range(6))
def test_circuit_breaker_matches_reference(seed):
    """The same seeded sequence of failures, successes and clock steps
    through both breakers: the same mode, admission and retry-after after
    every event, and the same transition log."""
    rng = random.Random(seed)
    cfg = dict(fail_threshold=rng.randint(1, 3),
               open_threshold=rng.randint(1, 3),
               recovery_successes=rng.randint(1, 3),
               open_cooldown_s=rng.choice([0.5, 2.0, 5.0]))
    mine = res.CircuitBreaker(res.BreakerConfig(**cfg))
    want = jres.CircuitBreaker(jres.BreakerConfig(**cfg))
    t = 0.0
    for _ in range(200):
        t += rng.choice([0.0, 0.1, 0.7, 3.0])
        ev = rng.choice(["fail", "fail", "ok", "query"])
        for b in (mine, want):
            if ev == "fail":
                b.on_failure(t)
            elif ev == "ok":
                b.on_success(t)
        assert (mine.mode(t), mine.admits(t), mine.retry_after_s(t)) == \
            (want.mode(t), want.admits(t), want.retry_after_s(t))
    assert mine.transitions == want.transitions
    assert res.BreakerConfig.make(False) is None


def test_registers_the_reference_fault_points():
    """Every injection point ``repro`` registers for backends, serving and
    checkpoints, but ``exec_cache.get``, which guards XLA's executable
    cache: the port runs eagerly and has none (``api/backends.py``)."""
    want = {n for n in jres.registered_points()
            if n.split(".")[0] in ("backend", "serve", "checkpoint",
                                   "exec_cache")}
    mine = set(res.registered_points())
    assert want - mine == {"exec_cache.get"}
    assert {"backend.execute", "backend.execute.result",
            "backend.execute_batch", "backend.execute_batch.result",
            "serve.launch", "checkpoint.save", "checkpoint.restore"} <= mine


# --- checkpointed runs -------------------------------------------------------

def _plan():
    return plan(StencilProblem("diffusion2d", SHAPE),
                RunConfig(backend="hopper", par_time=2, bsize=16,
                          device="cpu"))


def _grid(seed):
    return np.random.default_rng(seed).uniform(
        0.5, 2.0, SHAPE).astype(np.float32)


def test_chunked_run_is_bit_identical_and_resumes(tmp_path):
    p = _plan()
    g = _grid(3)
    want = p.run(g, 10)
    ckdir = str(tmp_path / "ck")
    r = run_checkpointed(p, g, 10, checkpoint_every=3, checkpoint_dir=ckdir)
    assert torch.equal(r.grid, want)
    assert r.checkpoint_every == 4            # aligned up to par_time 2
    assert r.steps_saved == (4, 8, 10) and r.resumed_from == 0
    shutil.rmtree(os.path.join(ckdir, "step_00000010"))
    r2 = run_checkpointed(p, g, 10, checkpoint_every=3, checkpoint_dir=ckdir)
    assert r2.resumed_from == 8 and r2.chunks_run == 1
    assert torch.equal(r2.grid, want)
    r3 = run_checkpointed(p, g, 10, checkpoint_every=3, checkpoint_dir=ckdir)
    assert r3.chunks_run == 0 and torch.equal(r3.grid, want)


def test_killed_run_resumes_bit_identical(tmp_path):
    """A save that fails mid-run (the publish never happens) leaves the
    last complete step; the rerun resumes from it and ends bit for bit
    where an uninterrupted run does."""
    p = _plan()
    g = _grid(4)
    want = p.run(g, 12)
    ckdir = str(tmp_path / "ck")
    with FaultPlan([FaultSpec("checkpoint.save", nth=2)]).active():
        with pytest.raises(res.InjectedFault):
            run_checkpointed(p, g, 12, checkpoint_every=4,
                             checkpoint_dir=ckdir)
    assert complete_steps(ckdir) == [4]
    r = run_checkpointed(p, g, 12, checkpoint_every=4, checkpoint_dir=ckdir)
    assert r.resumed_from == 4 and r.steps_saved == (8, 12)
    assert torch.equal(r.grid, want)


def test_foreign_directory_refused(tmp_path):
    p = _plan()
    ckdir = str(tmp_path / "ck")
    p.run(_grid(5), 4, checkpoint_every=2, checkpoint_dir=ckdir)
    with pytest.raises(CheckpointMismatch):
        p.run(_grid(5), 6, checkpoint_every=2, checkpoint_dir=ckdir)
    other = plan(StencilProblem("diffusion2d", (8, 32)),
                 RunConfig(backend="hopper", par_time=2, bsize=16,
                           device="cpu"))
    with pytest.raises(CheckpointMismatch):
        other.run(np.ones((8, 32), np.float32), 4, checkpoint_every=2,
                  checkpoint_dir=ckdir)


def test_unhealthy_state_is_never_checkpointed(tmp_path):
    p = _plan()
    ckdir = str(tmp_path / "ck")
    with FaultPlan([FaultSpec("backend.execute.result",
                              action="nan")]).active():
        with pytest.raises(NumericalFault):
            run_checkpointed(p, _grid(6), 4, checkpoint_every=2,
                             checkpoint_dir=ckdir, health=True)
    assert complete_steps(ckdir) == []


def test_gc_keeps_the_newest_steps(tmp_path):
    p = _plan()
    ckdir = str(tmp_path / "ck")
    r = run_checkpointed(p, _grid(7), 12, checkpoint_every=2,
                         checkpoint_dir=ckdir, keep=2)
    assert r.steps_saved == (2, 4, 6, 8, 10, 12)
    assert complete_steps(ckdir) == [10, 12]
