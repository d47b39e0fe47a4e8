"""Combined spatial and temporal blocking in torch ops — the algorithm, as
the reference's ``core/engine.py`` states it.

Overlapped spatial blocks are materialized along leading block axes and
updated ``par_time`` fused time-steps at once, then each block's compute
region is stitched back (compute past the grid is sliced off: the paper's
"control only the flow of writes").  Where the reference ``vmap``s a
per-block pipeline, this module carries the blocks as leading axes of one
tensor, ``(*lead, *bnum, stream, *bsize)``, and every function counts axes
from the end, so any leading axes of the grid (a batch) come along.  The
streaming kernel (``kernels/csrc/stencil_stream.cu``) computes the same
values; this module is the ``engine`` backend and the multi-device
runtime's local worker (``core/distributed.py``).

Boundary conditions across fused steps (``core.boundary``): the local
kinds (clamp, reflect, constant) are re-imposed on out-of-grid positions
before every stage application (:func:`_reclamp`); the streaming axis is
padded under its kind by each application's getter, which is exact, since
a block carries the whole stream.  Periodic axes are never re-imposed:
the blocked axes wrap when the blocks are cut, and a wrapped halo is an
exact translated copy up to the ``rad``-per-step garbage creep that the
halo absorbs, as at interior block seams.

PE forwarding (paper §3.2): when ``iters % par_time != 0`` the last
super-step runs ``steps < par_time`` iterations and the trailing ones pass
values through, as unused PEs pass data down the chain.  The reference
selects with ``where(t < steps)``; here ``steps`` is a Python int, so a
trailing iteration computes nothing: a chain forwards the re-imposed
value, as the reference does, and a DAG its fields as they were.

Storage and accumulation (``core.precision``): a bf16 block widens to f32
inside a stage application and rounds back once per application.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import boundary, precision
from repro_torch.core.blocking import BlockGeometry
from repro_torch.core.stencils import Stencil


def _pad_blocked_dims(grid: torch.Tensor, geom: BlockGeometry,
                      bc=None) -> torch.Tensor:
    """Pad the blocked (trailing) axes under ``bc``: the halo on the left,
    the halo and the overhang of the last block on the right, so that every
    block is a slice in bounds.  A periodic axis wraps; the other kinds pad
    by their rule and :func:`_reclamp` refreshes them every application."""
    h = geom.size_halo
    kinds = boundary.kinds_of(bc, geom.ndim)
    out = grid
    nb = geom.ndim - 1
    for i, (d, p) in enumerate(zip(geom.blocked_dims, geom.padded_dims)):
        out = boundary.pad_axis(out, out.ndim - nb + i, h, p - d - h,
                                kinds[i + 1], boundary.fill_of(bc))
    return out


def _block_index(geom: BlockGeometry, dim_i: int,
                 device=None) -> torch.Tensor:
    """(bnum, bsize) indices into the padded grid of blocked axis ``dim_i``."""
    c, b, n = geom.csize[dim_i], geom.bsize[dim_i], geom.bnum[dim_i]
    return (torch.arange(n, device=device)[:, None] * c
            + torch.arange(b, device=device)[None, :])


def extract_blocks(grid: torch.Tensor, geom: BlockGeometry,
                   bc=None) -> torch.Tensor:
    """``(*lead, stream, *blocked)`` -> ``(*lead, *bnum, stream, *bsize)``
    overlapped blocks, any rank (1D: the whole stream is the one block)."""
    gp = _pad_blocked_dims(grid, geom, bc)
    nb = geom.ndim - 1
    lead = grid.ndim - geom.ndim
    for i in range(nb):
        # blocked axis i sits at lead + 1 + 2*i once earlier ones expanded
        ax = lead + 1 + 2 * i
        idx = _block_index(geom, i, grid.device)
        gp = gp.index_select(ax, idx.reshape(-1)).unflatten(ax, idx.shape)
    # (*lead, stream, bn0, bs0, bn1, bs1, ..) -> (*lead, bn0, .., stream,
    # bs0, ..)
    perm = (tuple(range(lead)) + tuple(lead + 1 + 2 * i for i in range(nb))
            + (lead,) + tuple(lead + 2 + 2 * i for i in range(nb)))
    return gp.permute(perm)


def stitch_blocks(blocks: torch.Tensor, geom: BlockGeometry) -> torch.Tensor:
    """Write-back: each block's compute region, halos and out-of-grid
    columns discarded (the paper's masked writes)."""
    h = geom.size_halo
    nb = geom.ndim - 1
    lead = blocks.ndim - geom.ndim - nb
    comp = blocks[(Ellipsis,)
                  + tuple(slice(h, h + c) for c in geom.csize)]
    # (*lead, bn0, .., stream, cs0, ..) -> (*lead, stream, bn0, cs0, ..)
    perm = (tuple(range(lead)) + (lead + nb,)
            + tuple(x for i in range(nb)
                    for x in (lead + i, lead + nb + 1 + i)))
    out = comp.permute(perm).reshape(
        blocks.shape[:lead] + (blocks.shape[lead + nb],)
        + tuple(n * c for n, c in zip(geom.bnum, geom.csize)))
    return out[(Ellipsis, slice(None))
               + tuple(slice(0, d) for d in geom.blocked_dims)]


def _mask_fill(arr: torch.Tensor, mask: torch.Tensor, shape,
               value: float) -> torch.Tensor:
    """Overwrite the positions ``mask`` (broadcast as ``shape``) selects
    with ``value`` (the 'constant' BC's re-imposition)."""
    fill = torch.tensor(value, dtype=arr.dtype, device=arr.device)
    return torch.where(mask.reshape(shape), fill, arr)


def _reclamp(blocks: torch.Tensor, geom: BlockGeometry, bounds=None,
             bc=None) -> torch.Tensor:
    """Re-impose the local BC on ``(*lead, *bnum, stream, *bsize)`` blocks:
    out-of-grid positions take, per axis, the mapped in-grid value (clamp,
    reflect) or the fill (constant).  Periodic axes are left alone, and an
    axis on which no block reaches out of its range is not touched.

    ``bounds``: optional ``((lo, hi), ...)`` physical-edge range per grid
    axis, in the grid's coordinates: the multi-device runtime's, where a
    shard's edge is either a seam (its bounds cover the whole extended
    shard: nothing to re-impose) or the grid's edge (the BC at the halo's
    offset).  ``None``: the BC at the grid's edges, nothing on the
    streaming axis (the getter pads it exactly)."""
    h = geom.size_halo
    nd, nb = geom.ndim, geom.ndim - 1
    kinds = boundary.kinds_of(bc, nd)
    value = boundary.fill_of(bc)
    dev = blocks.device
    if bounds is not None and kinds[0] != "periodic":
        n = blocks.shape[-nd]
        lo, hi = bounds[0]
        if lo > 0 or hi < n - 1:
            idx = torch.arange(n, device=dev)
            shape = (n,) + (1,) * nb
            if kinds[0] == "constant":
                blocks = _mask_fill(blocks, boundary.out_of_range(idx, lo, hi),
                                    shape, value)
            else:
                blocks = blocks.index_select(
                    blocks.ndim - nd,
                    boundary.map_index(idx, lo, hi, kinds[0]))
    for i, (dim, b, c) in enumerate(zip(geom.blocked_dims, geom.bsize,
                                        geom.csize)):
        kind = kinds[i + 1]
        if kind == "periodic":
            continue
        lo, hi = (0, dim - 1) if bounds is None else bounds[i + 1]
        # the blocks span grid coordinates -h .. (bnum-1)*c + b-1 - h
        if lo <= -h and hi >= (geom.bnum[i] - 1) * c + b - 1 - h:
            continue
        start = torch.arange(geom.bnum[i], device=dev)[:, None] * c
        gx = start + torch.arange(b, device=dev)[None, :] - h
        # (bnum_i, b) broadcast over (*bnum, stream, *bsize)
        shape = [1] * (nb + nd)
        shape[i] = geom.bnum[i]
        shape[nb + 1 + i] = b
        if kind == "constant":
            blocks = _mask_fill(blocks, boundary.out_of_range(gx, lo, hi),
                                shape, value)
        else:
            jc = boundary.map_index(gx, lo, hi, kind) + h - start
            idx = jc.clamp(0, b - 1).reshape(shape)
            axis = blocks.ndim - nb + i
            blocks = torch.gather(blocks, axis, idx.expand(blocks.shape))
    return blocks


def _block_getter(blocks: torch.Tensor, nd: int, r: int, bc=None):
    """Neighbour getter on blocks: the streaming axis padded exactly under
    its BC kind (a block carries the whole stream, so the padding IS the
    boundary there), the blocked axes edge-padded (the halo absorbs
    what that pads wrong)."""
    p = boundary.pad_axis(blocks, blocks.ndim - nd, r, r,
                          boundary.kinds_of(bc, 1)[0], boundary.fill_of(bc))
    for ax in range(blocks.ndim - nd + 1, blocks.ndim):
        p = boundary.pad_axis(p, ax, r, r, "clamp")
    shape = blocks.shape[-nd:]

    def get(off):
        return p[(Ellipsis,) + tuple(slice(r + o, r + o + n)
                                     for o, n in zip(off, shape))]

    return get


def _block_substep(stencil: Stencil, blocks: torch.Tensor, nd: int,
                   coeffs: dict, aux_blocks, bc=None) -> torch.Tensor:
    """One plain stencil application on blocks (see :func:`_block_getter`),
    under the storage/accumulation policy of ``core.precision``."""
    get = _block_getter(blocks, nd, stencil.radius, bc)
    return precision.apply_stage(stencil, get, coeffs, aux_blocks,
                                 blocks.dtype)


def _block_substep_dag(stencil: Stencil, inputs, nd: int, coeffs: dict,
                       aux_blocks, bc=None) -> torch.Tensor:
    """One stage application on re-imposed input blocks: each input read
    under this stage's BC; a stencil of ``arity > 1`` receives a tuple of
    getters."""
    gets = [_block_getter(x, nd, stencil.radius, bc) for x in inputs]
    return precision.apply_stage(
        stencil, tuple(gets) if stencil.arity > 1 else gets[0], coeffs,
        aux_blocks, inputs[0].dtype)


def blocked_superstep_chain(stages, geom: BlockGeometry, grid: torch.Tensor,
                            stage_coeffs, steps: int,
                            aux: Optional[torch.Tensor] = None,
                            bounds=None) -> torch.Tensor:
    """Apply ``steps`` (<= ``par_time``) fused program iterations, each the
    whole stage chain in order, through one round trip of overlapped
    blocks.

    ``stages`` is the ``((stencil, bc), ...)`` chain (one stage recovers
    :func:`blocked_superstep`), ``stage_coeffs`` one dict per stage.  The
    blocks are cut under stage 0's BC (periodicity is uniform across
    stages) and each stage re-imposes its own BC before it reads.
    ``grid`` may carry leading axes (a batch); ``aux`` then is one grid
    shared by them or one per member.  ``bounds``: see :func:`_reclamp`."""
    bc0 = stages[0][1]
    nd = geom.ndim
    has_aux = any(st.has_aux for st, _ in stages)
    cur = extract_blocks(grid, geom, bc0)
    aux_blocks = extract_blocks(aux, geom, bc0) if has_aux else None
    for t in range(geom.par_time):
        for (st, bc_s), cf in zip(stages, stage_coeffs):
            cur = _reclamp(cur, geom, bounds, bc_s)
            if t < steps:       # else PE forwarding: the re-imposed value
                cur = _block_substep(st, cur, nd, cf,
                                     aux_blocks if st.has_aux else None,
                                     bc_s)
    return stitch_blocks(cur, geom)


def blocked_superstep_dag(dag, geom: BlockGeometry, state: torch.Tensor,
                          stage_coeffs, steps: int,
                          aux: Optional[torch.Tensor] = None,
                          bounds=None) -> torch.Tensor:
    """Apply ``steps`` (<= ``par_time``) fused program iterations of a
    stage DAG (:class:`repro_torch.programs.DagSpec`) through one round
    trip of overlapped blocks.

    ``state`` is the grid of a one-field program, else the ``(F, *shape)``
    stack, either after any leading axes: every field is blocked alike.
    Each iteration evaluates the stages in topological order, every input
    re-imposed under the consuming stage's BC, then updates every field at
    once; a field whose update is itself is carried unchanged."""
    F = dag.n_fields
    nd = geom.ndim
    fields = list(state.unbind(state.ndim - nd - 1)) if F > 1 else [state]
    bc0 = dag.stages[0][1]
    has_aux = any(st.has_aux for st, _, _ in dag.stages)
    cur = [extract_blocks(g, geom, bc0) for g in fields]
    aux_blocks = extract_blocks(aux, geom, bc0) if has_aux else None
    for _ in range(min(int(steps), geom.par_time)):
        vals: list = [None] * len(dag.stages)
        for si in dag.topo:
            st, bc_s, refs = dag.stages[si]
            ins = [cur[~r] if r < 0 else vals[r] for r in refs]
            recs = [_reclamp(x, geom, bounds, bc_s) for x in ins]
            vals[si] = _block_substep_dag(
                st, recs, nd, stage_coeffs[si],
                aux_blocks if st.has_aux else None, bc_s)
        cur = [cur[k] if u == ~k else vals[u] if u >= 0 else cur[~u]
               for k, u in enumerate(dag.updates)]
    outs = [stitch_blocks(u, geom) for u in cur]
    return torch.stack(outs, state.ndim - nd - 1) if F > 1 else outs[0]


def blocked_superstep(stencil: Stencil, geom: BlockGeometry,
                      grid: torch.Tensor, coeffs: dict, steps: int,
                      aux: Optional[torch.Tensor] = None, bounds=None,
                      bc=None) -> torch.Tensor:
    """One stage: :func:`blocked_superstep_chain` of ``((stencil, bc),)``."""
    return blocked_superstep_chain(((stencil, bc),), geom, grid, (coeffs,),
                                   steps, aux, bounds)


def _loop(superstep, state: torch.Tensor, par_time: int,
          iters: int) -> torch.Tensor:
    """``ceil(iters/par_time)`` super-steps (paper Eq. 8's numerator), the
    last one of ``iters - s*par_time`` iterations."""
    iters = int(iters)
    for s in range(-(-iters // par_time)):
        state = superstep(state, min(par_time, iters - s * par_time))
    return state


def superstep_loop_dag(dag, geom: BlockGeometry, state: torch.Tensor,
                       stage_coeffs, iters: int,
                       aux: Optional[torch.Tensor] = None,
                       bounds=None) -> torch.Tensor:
    """A whole run of a stage DAG: :func:`blocked_superstep_dag` super-steps,
    the last one partial (PE forwarding)."""
    return _loop(lambda g, steps: blocked_superstep_dag(
        dag, geom, g, stage_coeffs, steps, aux, bounds),
        state, geom.par_time, iters)


def superstep_loop_chain(stages, geom: BlockGeometry, grid: torch.Tensor,
                         stage_coeffs, iters: int,
                         aux: Optional[torch.Tensor] = None,
                         bounds=None) -> torch.Tensor:
    """A whole run of a stage chain: :func:`blocked_superstep_chain`
    super-steps, the last one partial (PE forwarding)."""
    return _loop(lambda g, steps: blocked_superstep_chain(
        stages, geom, g, stage_coeffs, steps, aux, bounds),
        grid, geom.par_time, iters)


def superstep_loop(stencil: Stencil, geom: BlockGeometry, grid: torch.Tensor,
                   coeffs: dict, iters: int,
                   aux: Optional[torch.Tensor] = None, bounds=None,
                   bc=None) -> torch.Tensor:
    """One stage: :func:`superstep_loop_chain` of ``((stencil, bc),)``."""
    return superstep_loop_chain(((stencil, bc),), geom, grid, (coeffs,),
                                iters, aux, bounds)


def run_blocked(stencil: Stencil, grid: torch.Tensor, coeffs: dict,
                iters: int, par_time: int, bsize,
                aux: Optional[torch.Tensor] = None, *,
                bc=None) -> torch.Tensor:
    """A full run of one stencil at ``(par_time, bsize)``: ``ceil(iters /
    par_time)`` super-steps (paper Eq. 8's numerator)."""
    if isinstance(bsize, int):
        bsize = (bsize,) * (grid.ndim - 1)
    geom = BlockGeometry(grid.ndim, tuple(grid.shape), stencil.radius,
                         par_time, tuple(bsize))
    return superstep_loop(stencil, geom, grid, coeffs, iters, aux, bc=bc)
