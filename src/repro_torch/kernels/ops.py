"""Super-step loops around the streaming kernel.

A run pads the blocked dims once (``_pad_blocked``), launches one super-step
per ``par_time`` iterations (``ceil(iters/par_time)`` in all, the last one
PE-forwarding ``iters % par_time``), refreshes the halo and overhang
columns between super-steps with torch ops (``_reclamp_padded``), and
slices the grid back out (``_slice_blocked``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import boundary
from repro_torch.core.blocking import BlockGeometry, stream_extension
from repro_torch.core.stencils import Stencil
from repro_torch.kernels.builder import superstep_chain


def pack_coeffs(stencil: Stencil, coeffs: dict) -> torch.Tensor:
    """The coefficients in ``stencil.coeff_names`` order, as a float32 CPU
    vector: the kernel takes them by value, so a launch never waits on the
    device for them."""
    return torch.stack([torch.as_tensor(coeffs[n], dtype=torch.float32)
                        .to("cpu").reshape(())
                        for n in stencil.coeff_names])


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


def fused_chain_loop(stages, geom: BlockGeometry, gp: torch.Tensor,
                     coeffs_packed: torch.Tensor, iters: int,
                     aux_p: torch.Tensor | None) -> torch.Tensor:
    """The whole ``iters`` loop of a stage chain over the pre-padded grid
    ``gp``, returning the unpadded result: a host loop of
    ``ceil(iters/par_time)`` super-steps, super-step ``s`` running
    ``min(par_time, iters - s*par_time)`` steps.  Padding and the halo
    refresh use stage 0's BC."""
    bc0 = stages[0][1]
    par_time = geom.par_time
    g = gp
    for s in range(math.ceil(iters / par_time)):
        steps = min(par_time, iters - s * par_time)
        g = superstep_chain(stages, geom, g, coeffs_packed, steps, aux_p)
        g = _reclamp_padded(g, geom, bc0)
    return _slice_blocked(g, geom, bc0).contiguous()


def fused_superstep_loop(stencil: Stencil, geom: BlockGeometry,
                         gp: torch.Tensor, coeffs_packed: torch.Tensor,
                         iters: int, aux_p: torch.Tensor | None,
                         bc=None) -> torch.Tensor:
    """Single-operator case of :func:`fused_chain_loop`."""
    return fused_chain_loop(((stencil, bc),), geom, gp, coeffs_packed, iters,
                            aux_p)


def dma_traffic_bytes(stencil: Stencil, geom: BlockGeometry,
                      cell_bytes: int = 4, bc=None) -> int:
    """Device-memory bytes one super-step of the streaming kernel moves:
    every block reads ``stream`` rows/planes of ``prod(bsize)`` cells per
    input stream (grid, and aux for Hotspot) and writes ``stream`` rows of
    ``prod(csize)`` cells; overlapping halo columns are read once per block
    that holds them."""
    dom = geom.stream_dim + 2 * stream_extension(geom, bc)
    stream = geom.stream_slabs(dom) * geom.par_vec
    reads = geom.num_blocks * stream * math.prod(geom.bsize) * stencil.num_read
    writes = (geom.num_blocks * stream * math.prod(geom.csize)
              * stencil.num_write)
    return (reads + writes) * cell_bytes
