"""Plain oracle: the unblocked iterated stencil, ground truth of the port.

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
