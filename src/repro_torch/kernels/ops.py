"""Super-step loops around the streaming kernel.

A run pads the blocked dims once (``_pad_blocked``), launches one super-step
of the whole stage program per ``par_time`` iterations
(``ceil(iters/par_time)`` in all, the last one PE-forwarding ``iters %
par_time``), refreshes the halo and overhang columns between super-steps
with torch ops (``_reclamp_padded``), and slices the grid back out
(``_slice_blocked``).  The coefficients of all stages travel as one packed
vector (``pack_program_coeffs``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import boundary
from repro_torch.core.blocking import BlockGeometry, stream_extension
from repro_torch.core.stencils import Stencil
from repro_torch.kernels.builder import superstep_dag


def pack_coeffs(stencil: Stencil, coeffs: dict) -> torch.Tensor:
    """The coefficients in ``stencil.coeff_names`` order, as a float32 CPU
    vector: the kernel takes them by value, so a launch never waits on the
    device for them."""
    return torch.stack([torch.as_tensor(coeffs[n], dtype=torch.float32)
                        .to("cpu").reshape(())
                        for n in stencil.coeff_names])


def pack_program_coeffs(stages, stage_coeffs) -> torch.Tensor:
    """The per-stage coefficient vectors concatenated in stage order: the
    layout ``programs.unroll_dag`` assigns ``coeff_lo`` offsets into.
    ``stages`` is ``((stencil, bc), ...)``, ``stage_coeffs`` one dict per
    stage."""
    return torch.cat([pack_coeffs(st, c)
                      for (st, _), c in zip(stages, stage_coeffs)])


def pack_dag_coeffs(dag, stage_coeffs) -> torch.Tensor:
    """:func:`pack_program_coeffs` for a ``programs.DagSpec``: authored
    stage order (evaluation follows ``dag.topo``; packing stays
    positional)."""
    return torch.cat([pack_coeffs(st, c)
                      for (st, _, _), c in zip(dag.stages, stage_coeffs)])


def _pad_blocked(grid: torch.Tensor, geom: BlockGeometry,
                 bc=None) -> torch.Tensor:
    """BC-pad the blocked (trailing) dims — halo left, halo + out-of-bound
    overhang right — plus the periodic stream extension, plus edge rows
    padding the stream up to a ``par_vec`` multiple.  Leading batch axes
    (in front of the streaming axis) are left untouched."""
    h = geom.size_halo
    kinds = boundary.kinds_of(bc, geom.ndim)
    fill = boundary.fill_of(bc)
    lead = grid.ndim - (geom.ndim - 1)       # batch axes + streaming axis
    out = grid
    for i, (d, p) in enumerate(zip(geom.blocked_dims, geom.padded_dims)):
        out = boundary.pad_axis(out, lead + i, h, p - d - h, kinds[i + 1],
                                fill)
    ext = stream_extension(geom, bc)
    if ext:
        out = boundary.pad_axis(out, lead - 1, ext, ext, "periodic")
    dom = geom.stream_dim + 2 * ext
    vpad = geom.stream_slabs(dom) * geom.par_vec - dom
    if vpad:
        out = boundary.pad_axis(out, lead - 1, 0, vpad, "clamp")
    return out.contiguous()


def _slice_blocked(gp: torch.Tensor, geom: BlockGeometry,
                   bc=None) -> torch.Tensor:
    h = geom.size_halo
    ext = stream_extension(geom, bc)
    idx = ((Ellipsis, slice(ext, ext + geom.stream_dim))
           + tuple(slice(h, h + d) for d in geom.blocked_dims))
    return gp[idx]


def _reclamp_padded(gp: torch.Tensor, geom: BlockGeometry,
                    bc=None) -> torch.Tensor:
    """Refresh the halo and overhang columns of a padded grid from its real
    columns, per each axis' BC rule: equal to
    ``_pad_blocked(_slice_blocked(gp))`` while staying in the padded layout.
    Axes whose pad is zero are skipped."""
    h = geom.size_halo
    kinds = boundary.kinds_of(bc, geom.ndim)
    fill = boundary.fill_of(bc)
    dev = gp.device
    ext = stream_extension(geom, bc)
    if ext:
        axis = gp.ndim - geom.ndim
        d = geom.stream_dim
        core = torch.remainder(torch.arange(d + 2 * ext, device=dev) - ext,
                               d) + ext
        # par_vec pad rows beyond the wrap map to themselves
        tail = torch.arange(d + 2 * ext, gp.shape[axis], device=dev)
        gp = gp.index_select(axis, torch.cat([core, tail]))
    for i, (d, p) in enumerate(zip(geom.blocked_dims, geom.padded_dims)):
        if p == d:
            continue
        axis = gp.ndim - (geom.ndim - 1) + i
        pos = torch.arange(p, device=dev) - h
        if kinds[i + 1] == "constant":
            shape = [1] * gp.ndim
            shape[axis] = p
            mask = boundary.out_of_range(pos, 0, d - 1).reshape(shape)
            gp = torch.where(mask, torch.tensor(fill, dtype=gp.dtype,
                                                device=dev), gp)
        else:
            idx = boundary.map_index(pos, 0, d - 1, kinds[i + 1]) + h
            gp = gp.index_select(axis, idx)
    return gp


def fused_dag_loop(dag, geom: BlockGeometry, gp: torch.Tensor,
                   coeffs_packed: torch.Tensor, iters: int,
                   aux_p: torch.Tensor | None) -> torch.Tensor:
    """The whole ``iters`` loop of a stage program (``programs.DagSpec``; a
    chain is its path graph) over the pre-padded state ``gp`` (``(ns,
    *padded)`` for one field, ``(F, ns, *padded)`` for several, every
    field padded alike), returning the unpadded result: a host loop of
    ``ceil(iters/par_time)`` super-steps, super-step ``s`` running
    ``min(par_time, iters - s*par_time)`` steps.  Padding and the halo
    refresh of all fields, one ``_reclamp_padded`` per super-step, use
    stage 0's BC (periodicity is uniform across stages).  A batch, ``gp``
    with a leading axis ``B`` (``aux_p`` shared or ``(B, *field)``),
    advances every member in each launch: still ``ceil(iters/par_time)``
    launches; each halo refresh copies the whole batch once."""
    bc0 = dag.stages[0][1]
    par_time = geom.par_time
    g = gp
    for s in range(math.ceil(iters / par_time)):
        steps = min(par_time, iters - s * par_time)
        g = superstep_dag(dag, geom, g, coeffs_packed, steps, aux_p)
        g = _reclamp_padded(g, geom, bc0)
    return _slice_blocked(g, geom, bc0).contiguous()


def dma_traffic_bytes(stencil, geom: BlockGeometry, cell_bytes: int = 4,
                      bc=None) -> int:
    """Device-memory bytes one super-step of the streaming kernel moves:
    every block reads ``stream`` rows/planes of ``prod(bsize)`` cells per
    input stream (``stencil.num_read``: one per field, and aux when any
    stage reads it; a program's intermediates never leave the chip) and
    writes ``stream`` rows of ``prod(csize)`` cells per field
    (``stencil.num_write``); overlapping halo columns are read once per
    block that holds them.  ``stream`` counts the periodic extension and
    the pad up to a multiple of ``par_vec`` (the TPU kernel moves whole
    slabs; the Hopper kernel skips the pad rows, so this bills a little
    more than it moves)."""
    dom = geom.stream_dim + 2 * stream_extension(geom, bc)
    stream = geom.stream_slabs(dom) * geom.par_vec
    reads = geom.num_blocks * stream * math.prod(geom.bsize) * stencil.num_read
    writes = (geom.num_blocks * stream * math.prod(geom.csize)
              * stencil.num_write)
    return (reads + writes) * cell_bytes
