"""Backend registry.

A backend is a factory ``factory(problem, config, geom) -> execute`` with
``execute(grid, coeffs, iters, aux) -> grid``; ``plan()`` resolves
``RunConfig.backend`` through the registry.  The built-ins:

  ``reference``  the port's unblocked oracle (``kernels/ref.py``): bare
                 stencils, stage chains and stage DAGs
  ``hopper``     the streaming kernel path (``kernels/ops.py`` around
                 ``kernels/csrc/stencil_stream.cu``; plain version on CPU):
                 bare stencils, stage chains and stage DAGs, fused

``execute`` takes one coefficient dict for a single-stage problem and a
tuple of per-stage dicts for a program.  The ``hopper`` factory refuses, at
plan time, what this slice of the port does not cover, and names the
ROADMAP item that will add it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core.blocking import BlockGeometry
from repro_torch.kernels.builder import (KERNEL_DTYPES, kernel_limits,
                                          stage_op)
from repro_torch.kernels.ops import (_pad_blocked, fused_dag_loop,
                                     pack_dag_coeffs)
from repro_torch.kernels.ref import (oracle_dag_run, oracle_program_run,
                                     oracle_run)

#: (grid, coeffs, iters, aux) -> final grid
ExecuteFn = Callable[..., torch.Tensor]
Backend = Callable[[StencilProblem, RunConfig, Optional[BlockGeometry]],
                   ExecuteFn]

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
        raise ValueError("backend 'hopper' runs pinned schedules: pass "
                         "RunConfig(par_time=..., bsize=...) (autotuning is "
                         "ROADMAP A11)")
    if problem.torch_dtype not in KERNEL_DTYPES:
        raise ValueError(f"backend 'hopper' stores float32 or bfloat16, as "
                         f"the reference's Pallas kernels do; got "
                         f"{problem.dtype}")
    unported = [s.name for s in problem.stages if stage_op(s.stencil) is None]
    if unported:
        raise ValueError(f"backend 'hopper' runs the Table-2 stencils, "
                         f"make_star/make_box tap sums and make_combine "
                         f"fan-in; stages {unported} are none of these "
                         f"(ROADMAP B1i)")
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
    return execute


register_backend("reference", _reference_backend)
register_backend("hopper", _hopper_backend)
