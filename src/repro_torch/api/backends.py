"""Backend registry.

A backend is a factory ``factory(problem, config, geom) -> execute`` with
``execute(grid, coeffs, iters, aux) -> grid``; ``plan()`` resolves
``RunConfig.backend`` through the registry.  The built-ins:

  ``reference``  the port's unblocked oracle (``kernels/ref.py``)
  ``hopper``     the streaming kernel path (``kernels/ops.py`` around
                 ``kernels/csrc/stencil_stream.cu``; plain version on CPU)

The ``hopper`` factory refuses, at plan time, what this slice of the port
does not cover, and names the ROADMAP item that will add it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core.blocking import BlockGeometry
from repro_torch.kernels.builder import KERNEL_IDS, kernel_limits
from repro_torch.kernels.ops import (_pad_blocked, fused_superstep_loop,
                                     pack_coeffs)
from repro_torch.kernels.ref import oracle_run

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


def _reference_backend(problem, config, geom):
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
    if problem.dtype != "float32":
        raise ValueError(f"backend 'hopper' runs float32 only; got "
                         f"{problem.dtype} (ROADMAP B1e)")
    if not problem.bc.is_clamp:
        raise ValueError(f"backend 'hopper' runs the clamp boundary only; "
                         f"got {problem.bc.token()} (ROADMAP B1c)")
    if config.par_vec != 1:
        raise ValueError(f"backend 'hopper' runs par_vec=1 only; got "
                         f"{config.par_vec} (ROADMAP B1d)")
    if problem.ndim == 1:
        raise ValueError("backend 'hopper' runs 2D and 3D grids; 1D is "
                         "ROADMAP B1d")
    if problem.stencil.name not in KERNEL_IDS:
        raise ValueError(f"backend 'hopper' runs {sorted(KERNEL_IDS)}; got "
                         f"{problem.stencil.name} (ROADMAP B1i)")
    limit = kernel_limits(geom)
    if limit:
        raise ValueError(f"backend 'hopper': {limit}")


def _hopper_backend(problem, config, geom):
    _refuse_hopper(problem, config, geom)
    st, bc = problem.exec_stages[0]

    def execute(grid, coeffs, iters, aux=None):
        gp = _pad_blocked(grid, geom, bc)
        aux_p = None if aux is None else _pad_blocked(aux, geom, bc)
        return fused_superstep_loop(st, geom, gp, pack_coeffs(st, coeffs),
                                    iters, aux_p, bc=bc)
    return execute


register_backend("reference", _reference_backend)
register_backend("hopper", _hopper_backend)
