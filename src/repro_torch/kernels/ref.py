"""Plain oracle: the unblocked iterated stencil, stage chain and stage DAG,
ground truth of the port.

Each time-step pads the whole grid under the boundary condition (per-axis
gathers, ``core.boundary.pad_axis``) and applies the stencil once; there is
no spatial or temporal blocking.
"""
from __future__ import annotations

import torch

from repro_torch.core import boundary, precision
from repro_torch.core.stencils import Stencil


def _padded_getter(grid: torch.Tensor, r: int, bc=None):
    """Neighbour getter over ``grid`` BC-padded by ``r`` on every axis."""
    p = grid
    for ax, kind in enumerate(boundary.kinds_of(bc, grid.ndim)):
        p = boundary.pad_axis(p, ax, r, r, kind, boundary.fill_of(bc))

    def get(off):
        idx = tuple(slice(r + o, r + o + n) for o, n in zip(off, grid.shape))
        return p[idx]

    return get


def oracle_step(stencil: Stencil, grid: torch.Tensor, coeffs: dict,
                aux: torch.Tensor | None = None, *, bc=None) -> torch.Tensor:
    """One time-step over the full grid under ``bc`` (default: clamp)."""
    get = _padded_getter(grid, stencil.radius, bc)
    return precision.apply_stage(stencil, get, coeffs, aux, grid.dtype)


def oracle_run(stencil: Stencil, grid: torch.Tensor, coeffs: dict,
               iters: int, aux: torch.Tensor | None = None, *,
               bc=None) -> torch.Tensor:
    """``iters`` time-steps."""
    for _ in range(int(iters)):
        grid = oracle_step(stencil, grid, coeffs, aux, bc=bc)
    return grid


def oracle_program_step(stages, grid: torch.Tensor, stage_coeffs,
                        aux: torch.Tensor | None = None) -> torch.Tensor:
    """One program iteration of the chain ``stages = ((stencil, bc),
    ...)``: every stage in order under its own BC, with one coefficient
    dict per stage."""
    for (st, bc_s), cf in zip(stages, stage_coeffs):
        grid = oracle_step(st, grid, cf, aux if st.has_aux else None,
                           bc=bc_s)
    return grid


def oracle_program_run(stages, grid: torch.Tensor, stage_coeffs,
                       iters: int, aux: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """``iters`` program iterations of the stage chain."""
    for _ in range(int(iters)):
        grid = oracle_program_step(stages, grid, stage_coeffs, aux)
    return grid


def oracle_dag_step(dag, state: torch.Tensor, stage_coeffs,
                    aux: torch.Tensor | None = None) -> torch.Tensor:
    """One program iteration of a :class:`~repro_torch.programs.DagSpec`:
    stages in topological order, each input (field or earlier stage) read
    under the consuming stage's BC, then every field updated at once.
    ``state`` is the grid for one field, else the ``(F, *shape)`` stack."""
    F = dag.n_fields
    fields = list(state.unbind(0)) if F > 1 else [state]
    vals: list = [None] * len(dag.stages)
    for si in dag.topo:
        st, bc_s, refs = dag.stages[si]
        ins = [vals[r] if r >= 0 else fields[~r] for r in refs]
        gets = [_padded_getter(x, st.radius, bc_s) for x in ins]
        vals[si] = precision.apply_stage(
            st, tuple(gets) if st.arity > 1 else gets[0],
            stage_coeffs[si], aux if st.has_aux else None, state.dtype)
    new = [vals[u] if u >= 0 else fields[~u] for u in dag.updates]
    return torch.stack(new) if F > 1 else new[0]


def oracle_dag_run(dag, state: torch.Tensor, stage_coeffs, iters: int,
                   aux: torch.Tensor | None = None) -> torch.Tensor:
    """``iters`` program iterations of the stage DAG."""
    for _ in range(int(iters)):
        state = oracle_dag_step(dag, state, stage_coeffs, aux)
    return state
