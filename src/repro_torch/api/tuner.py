"""Measured autotuning — time the model's shortlist, keep the fastest (the
reference's ``api/tuner.py``).

The paper tunes ``(bsize, par_time)`` from its performance model alone
(§4, §5.3).  ``RunConfig(autotune="measure")`` closes the loop as Table 4
does for the FPGA boards: the model's ``tune_top_k`` best schedules each
run on the selected backend and device, and the fastest wins.  Each
candidate carries its measured seconds and the paper's model accuracy
(estimated over measured time, §6.2), so ``StencilPlan.candidates`` reads
as a row of Table 4.

Timing (per candidate): ``tune_warmup`` untimed runs (the first launch of
a library builds and loads it), then ``tune_repeats`` timed runs of
``tune_iters`` iterations rounded up to whole super-steps (a partial
super-step costs a whole one), keeping the least: CUDA events on the card,
``time.perf_counter`` on the CPU (the kernels' plain versions).  Inputs
are made by a ``torch.Generator`` seeded 0 on the plan's device.
Candidates are ranked by seconds an iteration (``measured_s /
par_time``), which no run length changes, so one cached winner serves
runs of every length.  Nothing falls back: a candidate that fails to
launch raises.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.api.backends import as_program, get_backend
from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core import perf_model
from repro_torch.core.perf_model import Prediction


@dataclasses.dataclass(frozen=True)
class TunedCandidate:
    """One measured schedule: the model's view and the stopwatch's."""
    prediction: Prediction
    measured_s: float          # seconds a super-step (least over repeats)
    measured_run_time: float   # extrapolated seconds at iters_hint
    model_accuracy: float      # paper §6.2: estimated / measured time
    from_cache: bool = False   # True when served by the schedule cache

    @property
    def geom(self):
        return self.prediction.geom

    @property
    def s_per_iter(self) -> float:
        """Seconds a time-step: what candidates are ranked by."""
        return self.measured_s / self.geom.par_time

    def describe(self) -> str:
        src = "cache" if self.from_cache else "measured"
        return (f"bsize={self.geom.bsize} par_time={self.geom.par_time} "
                f"par_vec={self.geom.par_vec} -> "
                f"{self.measured_s * 1e3:.3f} ms/super ({src}, "
                f"model_accuracy={self.model_accuracy:.3g})")


def _time_once(execute, grid, coeffs, iters: int, aux) -> float:
    """Seconds of one ``execute``: CUDA events on the card, the host clock
    on the CPU."""
    if grid.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        execute(grid, coeffs, iters, aux)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    execute(grid, coeffs, iters, aux)
    return time.perf_counter() - t0


def make_inputs(problem: StencilProblem, device) -> tuple:
    """``(grid, aux)`` of ``problem`` on ``device``: the state
    ``uniform(0.5, 2)`` and, where a stage reads one, aux ``uniform(0,
    0.1)``, from a ``torch.Generator`` seeded 0 on that device."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    grid = torch.empty(problem.state_shape, device=device).uniform_(
        0.5, 2.0, generator=gen).to(problem.torch_dtype)
    aux = None
    if problem.needs_aux:
        aux = torch.empty(problem.shape, device=device).uniform_(
            0.0, 0.1, generator=gen).to(problem.torch_dtype)
    return grid, aux


def _payload(problem: StencilProblem):
    """The execute payload: one dict for a single-stage problem, else one
    per stage."""
    coeffs = problem.resolve_coeffs()
    return coeffs[0] if problem.n_stages == 1 else coeffs


def measure_candidate(problem: StencilProblem, config: RunConfig,
                      prediction: Prediction, grid, coeffs,
                      aux) -> TunedCandidate:
    """Time one candidate schedule on the configured backend and device."""
    geom = prediction.geom
    factory = get_backend(config.backend)
    execute = as_program(factory(problem, config, geom)).execute
    n_super = math.ceil((config.tune_iters or 1) / geom.par_time)
    iters = n_super * geom.par_time
    for _ in range(config.tune_warmup):
        _time_once(execute, grid, coeffs, iters, aux)
    best = min(_time_once(execute, grid, coeffs, iters, aux)
               for _ in range(config.tune_repeats))
    per_super = best / n_super
    run_time = per_super * prediction.n_super
    return TunedCandidate(
        prediction=prediction, measured_s=per_super,
        measured_run_time=run_time,
        model_accuracy=perf_model.model_accuracy(run_time, prediction))


def measure_candidates(problem: StencilProblem, config: RunConfig,
                       predictions: Sequence[Prediction],
                       ) -> Tuple[TunedCandidate, ...]:
    """Time every candidate; return them fastest an iteration first."""
    grid, aux = make_inputs(problem, config.device)
    coeffs = _payload(problem)
    tuned = [measure_candidate(problem, config, p, grid, coeffs, aux)
             for p in predictions]
    tuned.sort(key=lambda c: c.s_per_iter)
    return tuple(tuned)


def tune(problem: StencilProblem, config: Optional[RunConfig] = None,
         **overrides) -> "repro_torch.api.plan.StencilPlan":  # noqa: F821
    """``plan(problem, replace(config, autotune="measure", **overrides))``:
    the plan's ``candidates`` carry each schedule's measured seconds and
    model accuracy (the paper's Table 4 columns), and the winner is
    persisted to the schedule cache unless ``cache=False``."""
    from repro_torch.api.plan import plan   # circular at import, not at call
    overrides.pop("autotune", None)
    config = dataclasses.replace(config or RunConfig(),
                                 autotune="measure", **overrides)
    return plan(problem, config)
