"""The port's tuner on the CPU: ``plan()`` with the schedule left to the
performance model (``autotune="model"``) or to the measured tuner
(``"measure"``, the plain versions timed) against ``repro``'s tuned
plans on the same inputs, and bit for bit against the port's pinned plan
at the chosen geometry; and ``tests/test_tuner.py``'s cases on the port:
ranking, the persistent cache (hits, the salt, keys, user stencils,
unwritable paths, mangled entries, ``cache=False``, the environment path,
corruption, two writer processes), ``tune()``, the aliases and the knobs,
the fault points and the plan's introspection."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import api as japi
from repro.core import precision as jprecision
from repro_torch.api import (RunConfig, ScheduleCache, StencilProblem,
                             StencilProgram, StencilStage, TunedCandidate,
                             plan, tune)
from repro_torch.api import schedule_cache, tuner
from repro_torch.core import perf_model
from repro_torch.core.stencils import Stencil, make_combine, make_star
from repro_torch.resilience import FaultPlan, FaultSpec, registered_points

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (24, 96)


def _cfg(cache, **kw):
    kw.setdefault("backend", "hopper")
    kw.setdefault("device", "cpu")
    kw.setdefault("autotune", "measure")
    kw.setdefault("iters_hint", 8)
    kw.setdefault("tune_top_k", 2)
    kw.setdefault("tune_warmup", 1)
    kw.setdefault("tune_repeats", 2)
    return RunConfig(cache=cache, **kw)


def _spy(monkeypatch):
    """Count (and pass through) the measured tuner's calls."""
    calls = []
    real = tuner.measure_candidates

    def counting(problem, config, predictions):
        calls.append(problem.stencil.name)
        return real(problem, config, predictions)
    monkeypatch.setattr(tuner, "measure_candidates", counting)
    return calls


# --- tuned plans against repro's and the port's pinned plans ----------------

def _program(which, mod):
    if mod is None:
        Stage, Program, star, combine = (StencilStage, StencilProgram,
                                         make_star, make_combine)
    else:
        from repro.core.stencils import make_combine as jcombine
        from repro.core.stencils import make_star as jstar
        Stage, Program, star, combine = (mod.StencilStage, mod.StencilProgram,
                                         jstar, jcombine)
    if which == "chain":
        return [Stage(star(2, 1), coeffs={"c0": 0.7}), Stage("diffusion2d")]
    return Program(
        (Stage(star(2, 1), name="lapu", inputs=("u",)),
         Stage(combine(2, 3), name="unext", inputs=("u", "u_prev", "lapu"),
               coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


CASES = [("diffusion2d", (20, 72)), ("hotspot2d", (20, 72)),
         ("diffusion3d", (8, 24, 24)), ("hotspot3d", (8, 24, 24)),
         ("chain", (20, 72)), ("dag", (20, 72))]


@pytest.mark.parametrize("mode", ["model", "measure"])
@pytest.mark.parametrize("name,dims", CASES, ids=[c[0] for c in CASES])
def test_tuned_plan_runs_and_equals_reference_and_pinned(name, dims, mode,
                                                        tmp_path):
    """``plan(problem, RunConfig(backend="hopper"))`` with no schedule
    pinned plans and runs; the result agrees with ``repro``'s tuned
    ``reference`` plan within ``tolerance`` and equals the port's pinned
    plan at the tuned geometry bit for bit."""
    if name in ("chain", "dag"):
        spec, jspec = _program(name, None), _program(name, japi)
        stages = 2
    else:
        spec = jspec = name
        stages = 1
    bc = "periodic" if name == "dag" else "clamp"
    problem = StencilProblem(spec, dims, boundary=bc)
    cfg = (RunConfig(backend="hopper", device="cpu") if mode == "model"
           else _cfg(str(tmp_path / "s.json")))
    p = plan(problem, cfg)
    g = p.geometry
    assert g is not None and p.candidates
    first = p.candidates[0]
    assert getattr(first, "geom", None) == g
    if mode == "measure":
        assert isinstance(first, TunedCandidate) and not p.tuned_from_cache
    rng = np.random.default_rng(3)
    state = rng.uniform(0.5, 2.0, problem.state_shape).astype(np.float32)
    aux = (rng.uniform(0.0, 0.1, dims).astype(np.float32)
           if problem.needs_aux else None)
    iters = 2 * g.par_time + 1
    got = p.run(state, iters, aux=aux)
    pinned = plan(problem, RunConfig(backend="hopper", device="cpu",
                                     par_time=g.par_time, bsize=g.bsize,
                                     par_vec=g.par_vec))
    assert pinned.geometry == g and not pinned.candidates
    assert torch.equal(got, pinned.run(state, iters, aux=aux))
    jp = japi.plan(japi.StencilProblem(jspec, dims, boundary=bc),
                   japi.RunConfig(backend="reference",
                                  autotune=True if mode == "model"
                                  else False))
    want = jp.run(jnp.asarray(state), iters,
                  aux=None if aux is None else jnp.asarray(aux))
    scale = 100 if problem.needs_aux else None
    conf.assert_close(got, want, jprecision.tolerance(
        "float32", iters, stages, scale=scale))


def test_model_plan_is_the_models_best_and_describes_itself():
    problem = StencilProblem("hotspot2d", SHAPE)
    p = plan(problem, RunConfig(backend="hopper", device="cpu"))
    assert p.config.autotune is False and p.perf_device is perf_model.H100_SXM
    best = perf_model.autotune(problem.stencil, SHAPE, 100,
                               bc=problem.structural_bc)[0]
    assert p.candidates[0] == best and p.geometry == best.geom
    assert p.predicted() == best
    assert p.predicted(device="h200").run_time <= best.run_time
    assert p.predicted(batch=4).batch == 4
    text = p.describe()
    assert "schedule: bsize=" in text and "predicted:" in text
    report = p.traffic_report()
    assert report["cta_smem_bytes"] >= report["smem_bytes"] > 0
    assert report["cta_smem_bytes"] == best.smem_bytes


def test_pins_constrain_the_model():
    problem = StencilProblem("diffusion2d", SHAPE)
    for kw in ({"par_time": 2}, {"bsize": 64}, {"par_vec": 4},
               {"par_time": 4, "par_vec": 1}):
        p = plan(problem, RunConfig(backend="hopper", device="cpu", **kw))
        g = p.geometry
        assert all(getattr(g, k) == (v if k != "bsize" else (v,))
                   for k, v in kw.items()), (kw, g)
        assert all(getattr(c.geom, k) == getattr(g, k)
                   for c in p.candidates for k in kw)
    pinned = plan(problem, RunConfig(backend="hopper", device="cpu",
                                     par_time=2, bsize=32))
    assert pinned.geometry.par_vec == 1 and pinned.candidates == ()
    # autotune="model" over a pinned schedule still asks the model
    asked = plan(problem, RunConfig(backend="hopper", device="cpu",
                                    par_time=2, bsize=32, autotune=True))
    assert asked.candidates and asked.geometry.par_time == 2


def test_nothing_fits_names_shared_memory_and_the_pins():
    """An empty shortlist raises; a ``reference`` plan, which runs no
    schedule, has no geometry instead (as ``repro``'s degrades)."""
    problem = StencilProblem("diffusion2d", (8, 40))
    with pytest.raises(ValueError, match="shared memory.*par_time=40"):
        plan(problem, RunConfig(backend="hopper", device="cpu",
                                par_time=40))
    ref = plan(problem, RunConfig(backend="reference", device="cpu",
                                  par_time=40))
    assert ref.geometry is None
    with pytest.raises(ValueError, match="geometry"):
        ref.predicted()
    g = np.ones((8, 40), np.float32)
    assert torch.equal(ref.run(g, 2), plan(problem, RunConfig(
        backend="reference", device="cpu")).run(g, 2))
    with pytest.raises(ValueError, match="cell_bytes=2"):
        plan(problem, RunConfig(backend="hopper", device="cpu",
                                cell_bytes=2))


def test_resolved_perf_device():
    assert RunConfig(device="cpu").resolved_perf_device() is \
        perf_model.H100_SXM
    assert RunConfig(device="cpu", perf_device="h100_pcie"
                     ).resolved_perf_device().n_sm == 114
    dev = perf_model.H200.scaled(n_sm=100)
    assert RunConfig(device="cpu", perf_device=dev).resolved_perf_device() \
        is dev
    with pytest.raises(ValueError, match="unknown perf_device"):
        RunConfig(device="cpu", perf_device="tpu_v5e").resolved_perf_device()
    assert RunConfig().par_vec is None and RunConfig().backend == "hopper"


# --- measured selection -------------------------------------------------------

@pytest.mark.parametrize("name,dims", [("diffusion2d", SHAPE),
                                       ("hotspot3d", (8, 24, 24))])
def test_measure_selects_by_time_and_records(name, dims, tmp_path):
    p = plan(StencilProblem(name, dims), _cfg(str(tmp_path / "s.json")))
    assert not p.tuned_from_cache
    assert len(p.candidates) == 2
    for c in p.candidates:
        assert isinstance(c, TunedCandidate)
        assert c.measured_s > 0 and c.measured_run_time > 0
        assert c.model_accuracy > 0 and not c.from_cache
    per_iter = [c.s_per_iter for c in p.candidates]
    assert per_iter == sorted(per_iter)
    assert p.geometry == p.candidates[0].geom
    model = plan(StencilProblem(name, dims),
                 RunConfig(backend="hopper", device="cpu", iters_hint=8))
    assert {c.geom for c in p.candidates} == {
        c.geom for c in model.candidates[:2]}
    assert "measured:" in p.describe()


def test_a_candidate_that_fails_to_launch_raises(tmp_path, monkeypatch):
    """No fallback: a failing candidate stops the tune."""
    from repro_torch.api import backends

    def broken(problem, config, geom):
        def execute(grid, coeffs, iters, aux=None):
            raise RuntimeError("stencil_stream launch failed")
        return execute
    monkeypatch.setitem(backends._REGISTRY, "hopper", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        plan(StencilProblem("diffusion2d", SHAPE),
             _cfg(str(tmp_path / "s.json")))
    assert not (tmp_path / "s.json").exists()


def test_timing_protocol_counts_whole_super_steps(monkeypatch):
    """``tune_warmup`` untimed and ``tune_repeats`` timed runs of
    ``tune_iters`` rounded up to whole super-steps; the least is kept."""
    problem = StencilProblem("diffusion2d", SHAPE)
    pred = perf_model.predict(problem.stencil, SHAPE, 10, 32, 4)
    seen, times = [], iter([5.0, 3.0, 4.0, 2.0])
    monkeypatch.setattr(tuner, "_time_once",
                        lambda ex, g, c, iters, aux: (seen.append(iters),
                                                      next(times))[1])
    cfg = RunConfig(device="cpu", tune_warmup=1, tune_repeats=3,
                    tune_iters=6, iters_hint=10)
    grid, aux = tuner.make_inputs(problem, "cpu")
    c = tuner.measure_candidate(problem, cfg, pred, grid,
                                tuner._payload(problem), aux)
    assert seen == [8, 8, 8, 8]           # ceil(6 / 4) = 2 super-steps
    assert c.measured_s == 1.0            # min(3, 4, 2) / 2, 5 untimed
    assert c.measured_run_time == 1.0 * pred.n_super
    assert c.s_per_iter == 1.0 / 4
    assert c.model_accuracy == pred.run_time / c.measured_run_time


def test_inputs_come_from_a_seeded_generator():
    problem = StencilProblem("hotspot2d", SHAPE)
    g1, a1 = tuner.make_inputs(problem, "cpu")
    g2, a2 = tuner.make_inputs(problem, torch.device("cpu"))
    assert torch.equal(g1, g2) and torch.equal(a1, a2)
    assert float(g1.min()) >= 0.5 and float(a1.max()) <= 0.1
    dag = StencilProblem(_program("dag", None), SHAPE)
    g, aux = tuner.make_inputs(dag, "cpu")
    assert g.shape == (2,) + SHAPE and aux is None
    bf = StencilProblem("diffusion2d", SHAPE, dtype="bfloat16")
    assert tuner.make_inputs(bf, "cpu")[0].dtype == torch.bfloat16


# --- the cache ------------------------------------------------------------------

def test_cache_hit_skips_retiming(tmp_path, monkeypatch):
    calls = _spy(monkeypatch)
    cfg = _cfg(str(tmp_path / "s.json"))
    problem = StencilProblem("diffusion2d", SHAPE)
    p1 = plan(problem, cfg)
    assert calls == ["diffusion2d"] and not p1.tuned_from_cache
    p2 = plan(problem, cfg)
    assert calls == ["diffusion2d"], "second plan() must not re-time"
    assert p2.tuned_from_cache and p2.geometry == p1.geometry
    (cached,) = p2.candidates
    assert cached.from_cache
    assert cached.measured_s == pytest.approx(p1.candidates[0].measured_s)
    assert cached.model_accuracy == pytest.approx(
        p1.candidates[0].model_accuracy)
    g = np.random.default_rng(0).uniform(0.5, 2, SHAPE).astype(np.float32)
    assert torch.equal(p1.run(g, 5), p2.run(g, 5))


def test_salt_change_invalidates(tmp_path, monkeypatch):
    calls = _spy(monkeypatch)
    cfg = _cfg(str(tmp_path / "s.json"))
    problem = StencilProblem("diffusion2d", SHAPE)
    monkeypatch.setattr(schedule_cache, "code_version_salt", lambda: "aaaa")
    plan(problem, cfg)
    assert plan(problem, cfg).tuned_from_cache and len(calls) == 1
    monkeypatch.setattr(schedule_cache, "code_version_salt", lambda: "bbbb")
    p = plan(problem, cfg)
    assert not p.tuned_from_cache and len(calls) == 2


@pytest.mark.parametrize("source", ["kernels/csrc/stencil_stream.cu",
                                    "kernels/builder.py",
                                    "kernels/csrc/hopper.cuh",
                                    "core/blocking.py"])
def test_an_edit_of_the_kernel_sources_changes_the_salt(source, tmp_path):
    pkg = Path(schedule_cache.__file__).resolve().parents[1]
    for rel in schedule_cache.SALTED_SOURCES:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(pkg / rel, tmp_path / rel)
    before = schedule_cache.salt_of(tmp_path)
    assert before == schedule_cache.code_version_salt()
    with open(tmp_path / source, "a") as f:
        f.write("\n")
    assert schedule_cache.salt_of(tmp_path) != before


def test_key_differs_per_backend_device_host_and_pin():
    problem = StencilProblem("diffusion2d", SHAPE)
    dev = perf_model.H100_SXM
    base = schedule_cache.schedule_key(problem, _cfg(None), dev)
    for other_cfg, other_dev in [
            (_cfg(None, backend="reference"), dev),
            (_cfg(None, par_time=4), dev),
            (_cfg(None, bsize=256), dev),
            (_cfg(None, par_vec=2), dev),
            (_cfg(None, par_time_max=8), dev),
            (_cfg(None, tune_top_k=8), dev),
            (_cfg(None), perf_model.H200)]:
        assert schedule_cache.schedule_key(problem, other_cfg,
                                           other_dev) != base
    assert schedule_cache.schedule_key(
        problem, _cfg(None, iters_hint=999), dev) == base
    assert f"torch {torch.__version__}" in base and "/cpu|" in base
    assert "device=h100_sxm" in base
    assert schedule_cache.schedule_key(
        StencilProblem("diffusion2d", SHAPE, dtype="bfloat16"), _cfg(None),
        dev) != base


def test_key_fingerprints_user_stencils_beyond_name():
    cheap = Stencil("mystencil", 2, 1, 1, 1, 1, False, ("c",),
                    lambda get, c, aux=None: c["c"] * get((0, 0)))
    heavy = Stencil("mystencil", 2, 1, 5, 1, 1, False, ("c",),
                    lambda get, c, aux=None: c["c"] * (
                        get((0, 1)) + get((0, -1)) + get((1, 0))))
    keys = [schedule_cache.schedule_key(StencilProblem(st, SHAPE),
                                        _cfg(None), perf_model.H100_SXM)
            for st in (cheap, heavy)]
    assert keys[0] != keys[1]


def test_unwritable_cache_warns_instead_of_discarding_tune(tmp_path):
    (tmp_path / "blocker").write_text("")
    bad = tmp_path / "blocker" / "s.json"
    with pytest.warns(RuntimeWarning, match="not persisted"):
        ScheduleCache(bad).put("k", {"par_time": 2})
    with pytest.warns(RuntimeWarning, match="not persisted"):
        p = plan(StencilProblem("diffusion2d", SHAPE), _cfg(str(bad)))
    assert p.geometry is not None and not p.tuned_from_cache


def test_mangled_or_refused_cache_entry_is_a_miss(tmp_path, monkeypatch):
    calls = _spy(monkeypatch)
    path = str(tmp_path / "s.json")
    cfg = _cfg(path)
    problem = StencilProblem("diffusion2d", SHAPE)
    plan(problem, cfg)
    cache = ScheduleCache(path)
    key = schedule_cache.schedule_key(problem, cfg, perf_model.H100_SXM)
    for bad in ({"par_time": "soon", "note": "hand-edited"},
                {"par_time": 0, "bsize": [32], "measured_s": 0.1,
                 "model_accuracy": 1.0},
                {"par_time": 2, "bsize": [32, 32], "measured_s": 0.1,
                 "model_accuracy": 1.0},
                {"par_time": 20, "bsize": [32], "measured_s": 0.1,
                 "model_accuracy": 1.0},         # no compute block left
                {"par_time": 2, "bsize": [32], "par_vec": 4096,
                 "measured_s": 0.1, "model_accuracy": 1.0}):  # no CTA fits
        cache.put(key, bad)
        n = len(calls)
        p = plan(problem, cfg)
        assert not p.tuned_from_cache and len(calls) == n + 1, bad
    assert plan(problem, cfg).tuned_from_cache


def test_cache_false_and_the_default_path(tmp_path, monkeypatch):
    calls = _spy(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_SCHEDULE_CACHE",
                       str(tmp_path / "untouched.json"))
    problem = StencilProblem("diffusion2d", SHAPE)
    plan(problem, _cfg(False))
    plan(problem, _cfg(False))
    assert len(calls) == 2 and not (tmp_path / "untouched.json").exists()
    assert schedule_cache.default_cache_path() == tmp_path / "untouched.json"
    plan(problem, _cfg(None))
    assert plan(problem, _cfg(True)).tuned_from_cache
    assert len(ScheduleCache(tmp_path / "untouched.json")) == 1
    monkeypatch.delenv("REPRO_TORCH_SCHEDULE_CACHE")
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert schedule_cache.default_cache_path() == \
        tmp_path / "xdg" / "repro_torch" / "schedules.json"


def test_cache_file_is_versioned_json_and_corruption_safe(tmp_path):
    path = tmp_path / "s.json"
    cache = ScheduleCache(path)
    assert cache.get("k") is None
    cache.put("k", {"par_time": 4, "bsize": [256], "measured_s": 0.1,
                    "model_accuracy": 1.0})
    data = json.loads(path.read_text())
    assert data["version"] == schedule_cache.CACHE_FORMAT_VERSION
    assert cache.get("k")["par_time"] == 4 and "saved_at" in cache.get("k")
    path.write_text("{not json")
    assert cache.get("k") is None
    cache.put("k2", {"par_time": 2})
    assert cache.get("k2")["par_time"] == 2
    path.write_text(json.dumps({"version": 99, "entries": {"k2": {}}}))
    assert len(cache) == 0
    assert ScheduleCache.resolve(False) is None
    assert ScheduleCache.resolve(str(path)).path == path


def test_fault_points(tmp_path):
    assert {"schedule_cache.get", "schedule_cache.put"} <= set(
        registered_points())
    cache = ScheduleCache(tmp_path / "s.json")
    cache.put("k", {"par_time": 4})
    with FaultPlan([FaultSpec("schedule_cache.get", exc=OSError)]).active():
        assert cache.get("k") is None
    with FaultPlan([FaultSpec("schedule_cache.put", exc=OSError)]).active():
        with pytest.warns(RuntimeWarning, match="not persisted"):
            cache.put("k3", {"par_time": 4})
    assert cache.get("k3") is None and cache.get("k")["par_time"] == 4


def test_two_process_put_race_loses_nothing(tmp_path):
    path = str(tmp_path / "shared.json")
    script = os.path.join(os.path.dirname(__file__),
                          "torch_schedule_cache_race_check.py")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    count = 40
    procs = [subprocess.Popen([sys.executable, script, path, prefix,
                               str(count)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for prefix in ("a", "b")]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    cache = ScheduleCache(path)
    assert len(cache) == 2 * count
    for prefix in ("a", "b"):
        for i in range(count):
            assert cache.get(f"{prefix}-{i}") is not None


def test_tune_helper_forces_measure_mode(tmp_path):
    p = tune(StencilProblem("diffusion2d", SHAPE),
             RunConfig(device="cpu", iters_hint=8, tune_top_k=2,
                       tune_repeats=2), cache=str(tmp_path / "s.json"))
    assert p.config.autotune == "measure"
    assert isinstance(p.candidates[0], TunedCandidate)
    p2 = tune(StencilProblem("diffusion2d", SHAPE),
              RunConfig(device="cpu", iters_hint=8, tune_top_k=1,
                        tune_repeats=1), autotune="measure",
              cache=str(tmp_path / "s.json"))
    assert p2.config.autotune == "measure"


# --- config surface -----------------------------------------------------------

def test_autotune_aliases():
    assert RunConfig(autotune=True).autotune == "model"
    assert RunConfig(autotune=False).autotune is False
    assert RunConfig(autotune="measure").autotune == "measure"
    with pytest.raises(ValueError, match="autotune"):
        RunConfig(autotune="fastest")


def test_tuning_knob_validation():
    with pytest.raises(ValueError, match="tune_top_k"):
        RunConfig(tune_top_k=0)
    with pytest.raises(ValueError, match="tune_warmup"):
        RunConfig(tune_warmup=-1)
    with pytest.raises(ValueError, match="tune_warmup"):
        RunConfig(tune_repeats=0)
    with pytest.raises(ValueError, match="tune_iters"):
        RunConfig(tune_iters=0)
    with pytest.raises(ValueError, match="par_vec"):
        RunConfig(par_vec=0)
    assert RunConfig(cell_bytes=2).resolved_cell_bytes("float32") == 2
    assert RunConfig().resolved_cell_bytes("bfloat16") == 2
    ref = japi.RunConfig()
    mine = RunConfig()
    for knob in ("par_time_max", "iters_hint", "tune_top_k", "tune_warmup",
                 "tune_repeats", "tune_iters", "cache", "cell_bytes"):
        assert getattr(mine, knob) == getattr(ref, knob), knob
