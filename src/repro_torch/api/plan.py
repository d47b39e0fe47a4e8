"""``plan(problem, config) -> StencilPlan`` — the public entry point.

As in the paper's workflow, the performance model prunes the (bsize,
par_time, par_vec) design space offline (§4, §5.3,
``core/perf_model.py``), optionally refined by timing the model's
shortlist (``api/tuner.py``, through ``api/schedule_cache.py``), and the
fixed schedule then runs any number of iterations.  A ``StencilPlan`` is
that schedule: reusable, and introspectable (``predicted()``,
``traffic_report()``, ``describe()``) without running anything."""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.api import schedule_cache, tuner
from repro_torch.api.backends import (ExecuteFn, as_program, get_backend,
                                      resolve_axis_map)
from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core import perf_model
from repro_torch.core.blocking import (BlockGeometry, extended_geometry,
                                       smem_bytes, superstep_traffic_bytes)
from repro_torch.core.perf_model import Device, Prediction

#: backends whose kernels realize ``par_vec``: the tuner sweeps it only
#: there (elsewhere an unpinned V stays 1)
PAR_VEC_BACKENDS = ("hopper",)

#: built-in backends that run a row a tick: a pinned ``par_vec > 1`` would
#: price a width they never run, so ``plan()`` refuses it there
SCALAR_TICK_BACKENDS = ("engine", "distributed")


@dataclasses.dataclass(frozen=True)
class ChipLayout:
    """How the model splits a plan over devices: ``n_chips`` shards in a
    ``chip_grid`` (shards per grid axis; None off a mesh) on ``n_cards``
    distinct devices."""
    n_chips: int = 1
    chip_grid: Optional[tuple] = None
    n_cards: int = 1


def _chip_layout(problem: StencilProblem, config: RunConfig) -> ChipLayout:
    """The ``distributed`` backend's shards for the performance model; one
    chip off a mesh.  Logical shards that share a card are priced as that
    card running them one after another, their exchange as a copy in its
    device memory (``perf_model.predict``)."""
    if config.backend != "distributed" or config.mesh is None:
        return ChipLayout()
    mesh = config.mesh
    chip_grid = tuple(math.prod(mesh.shape[a] for a in names) if names
                      else 1 for names in resolve_axis_map(problem, config))
    return ChipLayout(math.prod(chip_grid), chip_grid,
                      len(mesh.distinct_devices))


def _validate_distributed(problem: StencilProblem,
                          config: RunConfig) -> None:
    """Fail at plan time, not at the first ``run()``, when the mesh cannot
    split the grid evenly: the model ceil-divides, so only this catches
    it."""
    if config.backend != "distributed" or config.mesh is None:
        return
    from repro_torch.core.distributed import shard_extents
    shard_extents(problem.shape, resolve_axis_map(problem, config),
                  config.mesh)


def _candidate_shortlist(problem: StencilProblem, config: RunConfig,
                         device: Device, chips: ChipLayout,
                         top_k: Optional[int] = None):
    """Model-ranked predictions (§5.3 pruning), best first: the free
    dimensions of the schedule enumerated, kept where the kernel runs
    them (``builder.kernel_limits``: shared memory and tables) and ranked
    by predicted run time; ``top_k`` truncates to the shortlist the
    measured tuner times.  Raises ``ValueError`` when nothing runs."""
    par_vec = config.par_vec
    if par_vec is None and config.backend not in PAR_VEC_BACKENDS:
        par_vec = 1
    cands = perf_model.autotune(
        problem.stencil, problem.shape, config.iters_hint, device,
        config.resolved_cell_bytes(problem.dtype), config.par_time_max,
        chips.n_chips, chips.chip_grid, n_cards=chips.n_cards,
        par_time=config.par_time,
        bsize=config.normalized_bsize(problem.ndim), par_vec=par_vec,
        top_k=top_k, bc=problem.structural_bc)
    if not cands:
        raise ValueError(
            f"no (bsize, par_time, par_vec) of {problem.stencil.name} on "
            f"{problem.shape} fits a CTA's shared memory "
            f"({device.smem_per_cta} bytes on {device.name}) and leaves a "
            f"compute block under the pins par_time={config.par_time}, "
            f"bsize={config.bsize}, par_vec={config.par_vec}, "
            f"par_time_max={config.par_time_max}")
    return cands


def _resolve_schedule(problem: StencilProblem, config: RunConfig,
                      device: Device, chips: ChipLayout):
    """``(par_time, bsize, par_vec, candidates)``: pinned, or the model's
    best (§5.3).  An unpinned ``par_vec`` of a pinned schedule is 1."""
    par_time = config.par_time
    bsize = config.normalized_bsize(problem.ndim)
    if not config.autotune and par_time is not None and bsize is not None:
        return par_time, bsize, config.par_vec or 1, ()
    cands = _candidate_shortlist(problem, config, device, chips)
    best = cands[0].geom
    return best.par_time, best.bsize, best.par_vec, tuple(cands)


def _cached(problem: StencilProblem, config: RunConfig, device: Device,
            chips: ChipLayout, entry: dict):
    """The :class:`~repro_torch.api.tuner.TunedCandidate` of a cache entry,
    or None for one that is mangled or names a schedule the backend
    refuses (a miss: re-tune, never a crash)."""
    from repro_torch.kernels import builder
    try:
        par_time = int(entry["par_time"])
        bsize = tuple(int(b) for b in entry["bsize"])
        par_vec = int(entry.get("par_vec", 1))
        measured_s = float(entry["measured_s"])
        accuracy = float(entry["model_accuracy"])
        if (par_time < 1 or par_vec < 1 or len(bsize) != problem.ndim - 1
                or any(b < 1 for b in bsize) or not measured_s > 0):
            return None
        geom = BlockGeometry(problem.ndim, problem.shape,
                             problem.stencil.radius, par_time, bsize,
                             par_vec)
        if (config.backend == "hopper" and builder.kernel_limits(
                geom, problem.exec_dag, problem.cell_bytes)):
            return None
        pred = perf_model.predict(
            problem.stencil, problem.shape, config.iters_hint, bsize,
            par_time, device, config.resolved_cell_bytes(problem.dtype),
            chips.n_chips, chips.chip_grid, bc=problem.structural_bc,
            par_vec=par_vec, n_cards=chips.n_cards)
    except (KeyError, TypeError, ValueError):
        return None
    return tuner.TunedCandidate(
        prediction=pred, measured_s=measured_s,
        measured_run_time=measured_s * pred.n_super,
        model_accuracy=accuracy, from_cache=True)


def _resolve_measured(problem: StencilProblem, config: RunConfig,
                      device: Device, chips: ChipLayout):
    """``autotune="measure"``: the schedule from the persistent cache, or
    the model's shortlist timed on the backend with the winner persisted.
    Returns ``(par_time, bsize, par_vec, candidates, from_cache)``, the
    candidates :class:`~repro_torch.api.tuner.TunedCandidate`, fastest
    first."""
    cache = schedule_cache.ScheduleCache.resolve(config.cache)
    key = schedule_cache.schedule_key(problem, config, device,
                                      chips.n_chips, chips.chip_grid)
    if cache is not None:
        entry = cache.get(key)
        cand = None if entry is None else _cached(problem, config, device,
                                                  chips, entry)
        if cand is not None:
            g = cand.geom
            return g.par_time, g.bsize, g.par_vec, (cand,), True
    shortlist = _candidate_shortlist(problem, config, device, chips,
                                     top_k=config.tune_top_k)
    tuned = tuner.measure_candidates(problem, config, shortlist)
    best = tuned[0]
    if cache is not None:
        cache.put(key, {
            "stencil": problem.stencil.name,
            "par_time": best.geom.par_time, "bsize": list(best.geom.bsize),
            "par_vec": best.geom.par_vec, "measured_s": best.measured_s,
            "model_accuracy": best.model_accuracy,
        })
    return (best.geom.par_time, best.geom.bsize, best.geom.par_vec, tuned,
            False)


def plan(problem: StencilProblem,
         config: Optional[RunConfig] = None) -> "StencilPlan":
    """Pair ``problem`` with ``config`` into a reusable ``StencilPlan``,
    choosing the schedule the config leaves free (``autotune``).  Raises
    if the config's device is CUDA and no card is present, and for a
    schedule the backend cannot run; a ``reference`` plan, which runs no
    schedule, then has no geometry instead."""
    if config is None:
        config = RunConfig()
    factory = get_backend(config.backend)
    if config.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("RunConfig(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    if (config.backend == "hopper" and config.cell_bytes is not None
            and config.cell_bytes != problem.cell_bytes):
        raise ValueError(f"backend 'hopper' stores {problem.dtype} at "
                         f"{problem.cell_bytes} bytes a cell; "
                         f"cell_bytes={config.cell_bytes} would price "
                         "another kernel")
    if (config.par_vec is not None and config.par_vec > 1
            and config.backend in SCALAR_TICK_BACKENDS):
        raise ValueError(
            f"par_vec={config.par_vec} is the streaming kernel's knob; "
            f"backend {config.backend!r} runs a row a tick and cannot "
            f"honour it: pin par_vec only for {list(PAR_VEC_BACKENDS)} "
            "(or leave it unset)")
    _validate_distributed(problem, config)
    device = config.resolved_perf_device()
    chips = _chip_layout(problem, config)
    geom, cands, from_cache = None, (), False
    try:
        if config.autotune == "measure":
            par_time, bsize, par_vec, cands, from_cache = _resolve_measured(
                problem, config, device, chips)
        else:
            par_time, bsize, par_vec, cands = _resolve_schedule(
                problem, config, device, chips)
        geom = BlockGeometry(problem.ndim, problem.shape,
                             problem.stencil.radius, par_time, tuple(bsize),
                             par_vec)
    except ValueError:
        if config.backend != "reference":
            raise
    program = as_program(factory(problem, config, geom))
    return StencilPlan(problem=problem, config=config, geometry=geom,
                       _execute=program.execute,
                       _execute_batch=program.execute_batch,
                       candidates=cands, tuned_from_cache=from_cache,
                       perf_device=device, chips=chips)


@dataclasses.dataclass
class StencilPlan:
    """A reusable executable for one (problem, config) pair."""
    problem: StencilProblem
    config: RunConfig
    geometry: Optional[BlockGeometry]
    _execute: ExecuteFn = dataclasses.field(repr=False)
    #: the batched entry point (None: ``run_batch`` loops over ``run``)
    _execute_batch: Optional[ExecuteFn] = dataclasses.field(default=None,
                                                            repr=False)
    #: the tuner's candidates, best first (empty for a pinned schedule):
    #: :class:`~repro_torch.core.perf_model.Prediction`\ s of
    #: ``autotune="model"``, :class:`~repro_torch.api.tuner.TunedCandidate`\ s
    #: of ``"measure"``; ``candidates[0]`` is the schedule that runs
    candidates: tuple = ()
    #: True when the measured schedule came from the schedule cache (no
    #: candidate timed for this plan)
    tuned_from_cache: bool = False
    #: the card the model priced (``RunConfig.resolved_perf_device``)
    perf_device: Device = perf_model.H100_SXM
    #: the shards the model priced (the ``distributed`` backend's mesh)
    chips: ChipLayout = ChipLayout()

    @property
    def device(self) -> torch.device:
        return self.config.device

    def _state(self, x, shape, what: str) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=self.problem.torch_dtype,
                            device=self.device).contiguous()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        return t

    def _aux(self, aux, shapes, message: str) -> Optional[torch.Tensor]:
        """The aux grid, on the plan's device, of one of ``shapes``
        (``message`` otherwise)."""
        if not self.problem.needs_aux:
            if aux is not None:
                raise ValueError(f"{self.problem.stencil.name} takes no aux "
                                 "grid")
            return None
        if aux is None:
            raise ValueError(f"{self.problem.stencil.name} needs an aux "
                             "(power) grid")
        aux = torch.as_tensor(aux, dtype=self.problem.torch_dtype,
                              device=self.device).contiguous()
        if tuple(aux.shape) not in shapes:
            raise ValueError(message.format(tuple(aux.shape)))
        return aux

    def _payload(self, coeffs):
        """The execute payload: one dict for a single-stage problem, else
        one per stage; host-side, since the kernel takes coefficients by
        value."""
        coeffs = self.problem.resolve_coeffs(coeffs)
        return coeffs[0] if self.problem.n_stages == 1 else coeffs

    def run(self, grid, iters: int, coeffs=None, *, aux=None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> torch.Tensor:
        """Advance ``grid`` by ``iters`` time-steps (program iterations:
        each applies every stage).  ``coeffs`` overrides
        :func:`~repro_torch.core.stencils.default_coeffs` and the stages'
        own overrides by name: a dict for a single-stage problem, a
        sequence of per-stage dicts or ``None`` for a program.  ``aux`` is
        the Hotspot ``power`` grid.  A multi-field program takes and
        returns the ``(n_fields, *shape)`` stack (``problem.state_shape``).
        Inputs go to the plan's device.

        ``checkpoint_every`` with ``checkpoint_dir`` makes the run
        restartable (:func:`repro_torch.resilience.run_checkpointed`): the
        state is saved atomically every ``checkpoint_every`` iterations,
        rounded up to a super-step multiple, and a run that calls ``run``
        again with the same directory resumes from the last complete save;
        the final grid equals an uninterrupted run's bit for bit."""
        if (checkpoint_every is None) != (checkpoint_dir is None):
            raise ValueError("checkpoint_every and checkpoint_dir go "
                             "together — pass both or neither")
        if checkpoint_dir is not None:
            from repro_torch.resilience.checkpoint_run import \
                run_checkpointed
            return run_checkpointed(
                self, grid, iters, coeffs, aux=aux,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir).grid
        grid = self._state(grid, self.problem.state_shape, "grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        shape = self.problem.shape
        aux = self._aux(aux, (shape,), f"aux shape {{}} != problem shape "
                                       f"{shape}")
        coeffs = self._payload(coeffs)
        if iters == 0:
            return grid
        return self._execute(grid, coeffs, iters, aux)

    def run_batch(self, grids, iters: int, coeffs=None, *,
                  aux=None) -> torch.Tensor:
        """Advance a batch ``(B, *state_shape)`` of grids by ``iters``
        time-steps, each member as :meth:`run` would and equal to it bit for
        bit.  On ``hopper`` the batch is padded once and each super-step is
        one launch for all ``B`` members (the members run along the
        kernel's grid), so a run takes ``ceil(iters/par_time)`` launches
        whatever ``B``; a backend without a batched entry point loops over
        the members.  ``aux`` (Hotspot ``power``) is one grid of ``shape``
        shared by the batch or one per member, ``(B, *shape)``.  Shapes and
        aux are validated before anything runs."""
        grids = torch.as_tensor(grids, dtype=self.problem.torch_dtype,
                                device=self.device)
        state = self.problem.state_shape
        if grids.ndim != len(state) + 1 or tuple(grids.shape[1:]) != state:
            raise ValueError(f"run_batch needs grids of shape (B, *{state}); "
                             f"got {tuple(grids.shape)}")
        if grids.shape[0] < 1:
            raise ValueError("run_batch needs a batch of at least 1 grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        shape = self.problem.shape
        batched = (grids.shape[0],) + shape
        aux = self._aux(aux, (shape, batched),
                        f"aux shape {{}} must be {shape} (shared) or "
                        f"{batched} (per-batch)")
        coeffs = self._payload(coeffs)
        if iters == 0:
            return grids
        if self._execute_batch is None:
            per_member = aux is not None and aux.ndim > self.problem.ndim
            return torch.stack([
                self._execute(g.contiguous(), coeffs, iters,
                              aux[b] if per_member else aux)
                for b, g in enumerate(grids)])
        return self._execute_batch(grids, coeffs, iters, aux)

    def prewarm(self, batch_sizes=(1,), *, iters: int = 1, coeffs=None,
                single: bool = True) -> dict:
        """Load the plan's kernels and warm them before traffic arrives:
        one :meth:`run` of a zero state (``single``) and one
        :meth:`run_batch` of zeros per size in ``batch_sizes``, each
        ``iters`` steps (1: one super-step) and synchronized.  The first
        call on a card builds and loads the kernel library (compiled at
        first use; ``kernels/_build.py``).  An aux-taking stencil warms the
        per-member aux mode, the one the serving path uses.  Returns
        ``{"single": seconds, B: seconds, ...}`` per warmed entry."""
        if int(iters) < 1:
            raise ValueError(f"prewarm iters must be >= 1, got {iters}")
        sizes = sorted({int(b) for b in batch_sizes})
        if sizes and sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {sizes[0]}")
        prob, dev = self.problem, self.device
        zeros = torch.zeros(prob.state_shape, dtype=prob.torch_dtype,
                            device=dev)
        aux = (torch.zeros(prob.shape, dtype=prob.torch_dtype, device=dev)
               if prob.needs_aux else None)

        def timed(fn) -> float:
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        timings: dict = {}
        if single:
            timings["single"] = timed(
                lambda: self.run(zeros, iters, coeffs, aux=aux))
        for b in sizes:
            aux_b = None if aux is None else aux.expand((b,) + prob.shape)
            timings[b] = timed(lambda: self.run_batch(
                zeros.expand((b,) + prob.state_shape), iters, coeffs,
                aux=aux_b))
        return timings

    def traffic_report(self, iters: Optional[int] = None) -> dict:
        """Model traffic (paper Eq. 7/8) against the streaming kernel's
        device-memory bytes (``kernels/ops.dma_traffic_bytes``), the
        kernel's shared memory for its rings (``smem_bytes``) and what a
        CTA of its launch takes in all (``cta_smem_bytes``: dynamic and
        static, what the occupancy reads), and the fields with the
        streams read (``F`` plus aux) and written (``F``).
        For a program it adds the stages and the fusion accounting: the
        fused program's intermediates stay in shared memory (0
        device-memory bytes) where chained single-stage plans would write
        and re-read each of the ``S - 1`` intermediates once per
        iteration."""
        from repro_torch.kernels import builder
        from repro_torch.kernels.ops import dma_traffic_bytes
        geom = self._require_geometry("traffic_report()")
        dag = self.problem.exec_dag
        st = self.problem.stencil
        cb = self.problem.cell_bytes
        bc = self.problem.structural_bc
        model = superstep_traffic_bytes(extended_geometry(geom, bc),
                                        st.num_read, st.num_write, cb)
        kernel = dma_traffic_bytes(st, geom, cb, bc=bc)
        report = {
            "model_bytes_per_superstep": model,
            "kernel_dma_bytes_per_superstep": kernel,
            "traffic_accuracy": model / kernel,
            "redundancy": geom.redundancy,
            "par_vec": geom.par_vec,
            "smem_bytes": smem_bytes(geom, dag, cb),
            "cta_smem_bytes": (builder.launch_smem(dag, geom, cb)
                               + builder.static_smem(dag, geom, cb)),
            # device-memory streams per super-step: one per field, plus aux
            "fields": list(self.problem.fields),
            "streams_in": st.num_read,
            "streams_out": st.num_write,
        }
        n_stages = self.problem.n_stages
        if n_stages > 1:
            cells = math.prod(self.problem.shape)
            report["stages"] = [
                {"name": s.name, "radius": s.stencil.radius,
                 "flop_pcu": s.stencil.flop_pcu, "bc": s.boundary.token()}
                for s in self.problem.stages]
            report["intermediate_hbm_bytes_per_superstep"] = 0
            report["unfused_intermediate_bytes_per_superstep"] = (
                2 * (n_stages - 1) * cells * cb * geom.par_time)
        if iters is not None:
            n_super = math.ceil(iters / geom.par_time)
            report["n_super"] = n_super
            report["model_bytes_total"] = model * n_super
            report["kernel_dma_bytes_total"] = kernel * n_super
        return report

    def predicted(self, iters: Optional[int] = None,
                  device: Optional[Device] = None,
                  batch: int = 1) -> Prediction:
        """The performance model's :class:`Prediction` of this plan (paper
        §4) on ``device`` (default: the card the plan was priced for) for
        ``iters`` (default ``iters_hint``); ``batch > 1`` models
        :meth:`run_batch` (the aux stream billed once)."""
        geom = self._require_geometry("predicted()")
        if isinstance(device, str):
            device = perf_model.DEVICES[device]
        return perf_model.predict(
            self.problem.stencil, self.problem.shape,
            iters if iters is not None else self.config.iters_hint,
            geom.bsize, geom.par_time, device or self.perf_device,
            self.config.resolved_cell_bytes(self.problem.dtype),
            self.chips.n_chips, self.chips.chip_grid, batch=batch,
            bc=self.problem.structural_bc, par_vec=geom.par_vec,
            n_cards=self.chips.n_cards)

    def describe(self) -> str:
        st = self.problem.stencil
        lines = [f"StencilPlan[{self.config.backend}] {st.name} "
                 f"{self.problem.shape} {self.problem.dtype} "
                 f"bc={self.problem.bc.token()} on {self.device}"]
        if self.problem.n_stages > 1:
            for i, s in enumerate(self.problem.stages):
                lines.append(f"  stage {i}: {s.name} rad={s.stencil.radius} "
                             f"flop_pcu={s.stencil.flop_pcu} "
                             f"bc={s.boundary.token()}")
        if self.geometry is not None:
            g = self.geometry
            lines.append(f"  schedule: bsize={g.bsize} par_time={g.par_time} "
                         f"par_vec={g.par_vec} csize={g.csize} bnum={g.bnum} "
                         f"redundancy={g.redundancy:.3f}")
            lines.append("  predicted: " + self.predicted().describe())
            if self.candidates and isinstance(self.candidates[0],
                                              tuner.TunedCandidate):
                lines.append("  measured:  " + self.candidates[0].describe())
        else:
            lines.append("  schedule: none (unblocked oracle)")
        if self.config.mesh is not None and self.config.backend == \
                "distributed":
            c = self.chips
            lines.append(f"  mesh: {c.n_chips} shards, chip_grid="
                         f"{c.chip_grid}, on {c.n_cards} device(s) of "
                         f"{self.config.mesh}")
        return "\n".join(lines)

    def _require_geometry(self, what: str) -> BlockGeometry:
        if self.geometry is None:
            raise ValueError(f"{what} needs a block geometry; this "
                             f"'{self.config.backend}' plan has no "
                             "(bsize, par_time) that runs")
        return self.geometry
