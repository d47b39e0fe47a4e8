"""Backend registry.

A backend is a factory ``factory(problem, config, geom)`` that returns an
``execute(grid, coeffs, iters, aux) -> grid`` or a :class:`BackendProgram`
that adds ``execute_batch(grids, coeffs, iters, aux)`` over a leading
batch axis (``aux`` None, one grid shared by the batch, or one per
member); ``plan()`` resolves ``RunConfig.backend`` through the registry
and threads the reference's fault points through both entry points
(:func:`as_program`).  The built-ins:

  ``reference``  the port's unblocked oracle (``kernels/ref.py``): bare
                 stencils, stage chains and stage DAGs
  ``hopper``       the streaming kernel path (``kernels/ops.py`` around
                   ``kernels/csrc/stencil_stream.cu``; plain version on
                   CPU): bare stencils, stage chains and stage DAGs,
                   fused, with custom stencils through device functions
                   generated from their ``apply`` (``kernels/codegen.py``)
  ``engine``       the blocked engine in torch ops (``core/engine.py``):
                   the algorithm, on any device, launching no kernel
  ``distributed``  the engine on each shard of a grid split over
                   ``config.mesh`` (``core/distributed.py``), built at
                   its first run

``execute`` takes one coefficient dict for a single-stage problem and a
tuple of per-stage dicts for a program.  ``hopper``'s ``execute_batch``
pads the batch once and advances every member in each launch (one per
super-step, as a single grid), equal to sequential runs bit for bit;
``engine``'s carries the batch as a leading axis through every op and
``distributed``'s makes one exchange per sharded axis a super-step for
the whole batch; ``reference`` has none, so ``run_batch`` runs the
oracle member by member.  The ``hopper`` factory
refuses, at plan time, what this slice of the port does not cover, and
names the ROADMAP item that will add it.

The reference's ``exec_cache.get`` point has no counterpart: it guards
XLA's process-level executable cache, and PyTorch runs eagerly, so there
is no executable to cache; the port does not register it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core import engine
from repro_torch.core.blocking import BlockGeometry
from repro_torch.kernels.builder import (KERNEL_DTYPES, check_batch,
                                          kernel_limits, stage_op)
from repro_torch.kernels.ops import (_pad_blocked, fused_dag_loop,
                                     pack_dag_coeffs)
from repro_torch.kernels.ref import (oracle_dag_run, oracle_program_run,
                                     oracle_run)
from repro_torch.resilience.faults import (corrupt_point, fault_point,
                                           register_point)

#: (grid, coeffs, iters, aux) -> final grid
ExecuteFn = Callable[..., torch.Tensor]

# --- fault-injection seams (repro_torch.resilience; no-ops with no plan) ----
FP_EXECUTE = register_point(
    "backend.execute", "before any backend's single-grid execute")
FP_EXECUTE_RESULT = register_point(
    "backend.execute.result", "a single-grid result passes through "
    "(action='nan' poisons it)")
FP_EXECUTE_BATCH = register_point(
    "backend.execute_batch", "before any backend's batched execute")
FP_EXECUTE_BATCH_RESULT = register_point(
    "backend.execute_batch.result", "a batched result passes through "
    "(action='nan' + member=i poisons one member)")


@dataclasses.dataclass
class BackendProgram:
    """What a backend factory hands ``plan()``: the single-grid entry
    point and, optionally, the batched one (``None``: ``run_batch`` loops
    over ``execute``)."""
    execute: ExecuteFn
    execute_batch: Optional[ExecuteFn] = None


Backend = Callable[[StencilProblem, RunConfig, Optional[BlockGeometry]],
                   Union[ExecuteFn, BackendProgram]]


def as_program(obj: Union[ExecuteFn, BackendProgram]) -> BackendProgram:
    """Normalize a factory's return value (bare callable or program) and
    thread the ``backend.execute*`` fault points through it, so every
    backend, built-in or registered, has the injection seams."""
    if isinstance(obj, BackendProgram):
        program = obj
    elif callable(obj):
        program = BackendProgram(execute=obj)
    else:
        raise TypeError(f"backend factory returned {type(obj).__name__}; "
                        "expected a callable or BackendProgram")
    return _instrument(program)


def _instrument(program: BackendProgram) -> BackendProgram:
    """Wrap the entry points with their fault seams (idempotent)."""
    if getattr(program.execute, "_fault_instrumented", False):
        return program
    inner, inner_batch = program.execute, program.execute_batch

    def execute(grid, coeffs, iters, aux=None):
        fault_point(FP_EXECUTE)
        return corrupt_point(FP_EXECUTE_RESULT,
                             inner(grid, coeffs, iters, aux))
    execute._fault_instrumented = True

    execute_batch = None
    if inner_batch is not None:
        def execute_batch(grids, coeffs, iters, aux=None):
            fault_point(FP_EXECUTE_BATCH, {"batch": grids.shape[0]})
            return corrupt_point(FP_EXECUTE_BATCH_RESULT,
                                 inner_batch(grids, coeffs, iters, aux),
                                 {"batch": grids.shape[0]})
        execute_batch._fault_instrumented = True
    return BackendProgram(execute=execute, execute_batch=execute_batch)

_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, factory: Backend, *,
                     overwrite: bool = False) -> None:
    """Register ``factory`` under ``name`` for use as ``RunConfig.backend``."""
    if not callable(factory):
        raise TypeError(f"backend factory for {name!r} is not callable")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {list_backends()}") from None


def list_backends() -> list:
    return sorted(_REGISTRY)


def _stage_coeffs(problem: StencilProblem, coeffs) -> tuple:
    """The execute payload as one dict per stage."""
    return coeffs if problem.n_stages > 1 else (coeffs,)


def _reference_backend(problem, config, geom):
    if problem.is_dag:
        dag = problem.exec_dag

        def execute(grid, coeffs, iters, aux=None):
            return oracle_dag_run(dag, grid, _stage_coeffs(problem, coeffs),
                                  iters, aux)
    elif problem.n_stages > 1:
        stages = problem.exec_stages

        def execute(grid, coeffs, iters, aux=None):
            return oracle_program_run(stages, grid, coeffs, iters, aux)
    else:
        st, bc = problem.exec_stages[0]

        def execute(grid, coeffs, iters, aux=None):
            return oracle_run(st, grid, coeffs, iters, aux, bc=bc)
    return execute


def _refuse_hopper(problem: StencilProblem, config: RunConfig,
                   geom: Optional[BlockGeometry]) -> None:
    """Raise for anything the streaming kernel of this slice does not run."""
    if geom is None:
        raise ValueError("backend 'hopper' needs a schedule: plan() pins "
                         "or tunes one")
    if problem.torch_dtype not in KERNEL_DTYPES:
        raise ValueError(f"backend 'hopper' stores float32 or bfloat16, as "
                         f"the reference's Pallas kernels do; got "
                         f"{problem.dtype}")
    for s in problem.stages:   # traces a custom apply, on the CPU
        try:
            stage_op(s.stencil)
        except ValueError as e:
            raise ValueError(f"backend 'hopper': stage {s.name!r}: {e}"
                             ) from None
    limit = kernel_limits(geom, problem.exec_dag, problem.cell_bytes)
    if limit:
        raise ValueError(f"backend 'hopper': {limit}")


def _hopper_backend(problem, config, geom):
    _refuse_hopper(problem, config, geom)
    dag = problem.exec_dag
    bc0 = problem.structural_bc

    def execute(grid, coeffs, iters, aux=None):
        gp = _pad_blocked(grid, geom, bc0)
        aux_p = None if aux is None else _pad_blocked(aux, geom, bc0)
        packed = pack_dag_coeffs(dag, _stage_coeffs(problem, coeffs))
        return fused_dag_loop(dag, geom, gp, packed, iters, aux_p)

    def execute_batch(grids, coeffs, iters, aux=None):
        # the padding copies every member: refuse an over-cap batch first
        check_batch(grids.shape[0])
        return execute(grids, coeffs, iters, aux)
    return BackendProgram(execute, execute_batch)


def _engine_backend(problem, config, geom):
    if geom is None:
        raise ValueError("backend 'engine' needs a schedule: plan() pins "
                         "or tunes one")
    if problem.is_dag:
        dag = problem.exec_dag

        def execute(grid, coeffs, iters, aux=None):
            return engine.superstep_loop_dag(
                dag, geom, grid, _stage_coeffs(problem, coeffs), iters, aux)
    elif problem.n_stages > 1:
        stages = problem.exec_stages

        def execute(grid, coeffs, iters, aux=None):
            return engine.superstep_loop_chain(stages, geom, grid, coeffs,
                                               iters, aux)
    else:
        st, bc = problem.exec_stages[0]

        def execute(grid, coeffs, iters, aux=None):
            return engine.superstep_loop(st, geom, grid, coeffs, iters, aux,
                                         bc=bc)
    # the engine carries leading axes through: a batch, with one aux grid
    # shared by it or one per member, is one call
    return BackendProgram(execute, execute)


def resolve_axis_map(problem: StencilProblem, config: RunConfig) -> tuple:
    """The mesh axes that split each grid axis for the ``distributed``
    backend: ``config.axis_map``, else the streaming axis split over every
    mesh axis and the blocked axes whole."""
    if config.mesh is None:
        raise ValueError("backend='distributed' needs config.mesh (and "
                         "optionally config.axis_map)")
    if config.axis_map is not None:
        if len(config.axis_map) != problem.ndim:
            raise ValueError(f"axis_map {config.axis_map} must have one "
                             f"entry per grid axis ({problem.ndim})")
        return config.axis_map
    return (tuple(config.mesh.axis_names),) + (None,) * (problem.ndim - 1)


def _distributed_backend(problem, config, geom):
    from repro_torch.core import distributed
    if geom is None:
        raise ValueError("backend 'distributed' needs a schedule: plan() "
                         "pins or tunes one")
    mesh = config.mesh
    axis_map = resolve_axis_map(problem, config)
    if mesh.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh holds CUDA devices but no CUDA device "
                           "is available")
    chain = problem.n_stages > 1 and not problem.is_dag
    stages = problem.exec_stages if chain else None
    dag = problem.exec_dag if problem.is_dag else None
    distributed.shard_layout(problem.shape, axis_map, mesh,
                             distributed.halo_width(problem.stencil,
                                                    geom.par_time, stages,
                                                    dag))
    runners: Dict[tuple, Callable] = {}

    def runner(batch: bool, aux_batched: bool) -> Callable:
        # built at the first run, as the reference builds its program:
        # plan() touches no device of the mesh
        key = (batch, aux_batched)
        if key not in runners:
            runners[key] = distributed.build_distributed_fn(
                problem.stencil, problem.shape, geom.par_time, geom.bsize,
                mesh, axis_map, batch=batch, aux_batched=aux_batched,
                bc=problem.structural_bc, stages=stages, dag=dag)
        return runners[key]

    def execute(grid, coeffs, iters, aux=None):
        return runner(False, False)(grid, aux, coeffs, iters)

    def execute_batch(grids, coeffs, iters, aux=None):
        per_member = aux is not None and aux.ndim > problem.ndim
        return runner(True, per_member)(grids, aux, coeffs, iters)
    return BackendProgram(execute, execute_batch)


register_backend("reference", _reference_backend)
register_backend("hopper", _hopper_backend)
register_backend("engine", _engine_backend)
register_backend("distributed", _distributed_backend)
