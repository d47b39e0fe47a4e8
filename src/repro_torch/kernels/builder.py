"""One super-step of the streaming chain: the Hopper kernel's wrapper, its
plain version, and the launch counter.

:func:`superstep_chain` takes the padded grid ``gp`` (``(ns, *padded)``,
BC-padded by ``kernels/ops._pad_blocked``) and advances it by ``steps``
(<= ``par_time``) fused iterations of the stage chain ``stages = ((stencil,
bc), ...)``, writing the ``csize`` columns of every block into the padded
output layout.  The ``len(stages) * par_time`` unrolled entries run in
order; an entry whose iteration is ``>= steps`` forwards its input (PE
forwarding).  For a CUDA tensor it launches ``csrc/stencil_stream.cu``; for
a CPU tensor it runs :func:`superstep_plain`.  Nothing falls back: a CUDA
tensor goes to the kernel or raises.

The kernel computes a stage with one of two ops: the device function of a
Table-2 stencil (:data:`KERNEL_IDS`), or a tap table for a stencil whose
``apply`` is an ordered tap sum (``make_star``/``make_box``,
:func:`linear_taps`).  This slice covers linear chains of such stages on
2D and 3D grids, clamp boundary, float32, ``par_vec = 1``;
``api/backends`` refuses the rest at plan time.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core import boundary
from repro_torch.core.blocking import (MAX_THREADS, SMEM_LIMIT,
                                       BlockGeometry, smem_bytes)
from repro_torch.core.stencils import STENCILS, Stencil
from repro_torch.kernels import _build
from repro_torch.kernels._build import (MAX_COEFFS, MAX_ENTRIES, MAX_STAGES,
                                        MAX_TAPS, TABLE_SMEM)
from repro_torch.programs import chain_dag, dag_layout, unroll_dag

#: kernel launches made by :func:`superstep_chain` (CUDA tensors only)
LAUNCHES = 0

#: Table-2 stencil name -> its op id in ``stencil_stream.cu``
KERNEL_IDS = {"diffusion2d": 0, "hotspot2d": 1, "diffusion3d": 2,
              "hotspot3d": 3}
#: op id of the tap-table path
TAP_OP = 4


def linear_taps(stencil: Stencil):
    """The ordered ``(coefficient index, offset)`` pairs of a stencil whose
    ``apply`` is a tap sum, in the order ``apply`` adds them; ``None`` for
    any other stencil."""
    if not stencil.tap_sum or stencil.arity != 1 or stencil.has_aux:
        return None
    return tuple(enumerate(stencil.offsets))


def stage_op(stencil: Stencil) -> Optional[int]:
    """The kernel op that computes ``stencil`` (a Table-2 id or
    :data:`TAP_OP`), or ``None`` if the kernel has none."""
    if stencil.name in KERNEL_IDS and STENCILS[stencil.name] == stencil:
        return KERNEL_IDS[stencil.name]
    if linear_taps(stencil) is not None:
        return TAP_OP
    return None


def kernel_body(stages) -> int:
    """Which loop body of the kernel runs the chain: the Table-2 id for a
    single Table-2 stage (the paper's main path), else -1 (any chain)."""
    op = stage_op(stages[0][0])
    if len(stages) == 1 and op is not None and op != TAP_OP:
        return op
    return -1


def kernel_limits(geom: BlockGeometry, stages) -> Optional[str]:
    """Why the kernel cannot run the chain ``stages`` at ``geom`` (None if
    it can): one thread per block-plane cell, per CTA the
    :func:`smem_bytes` of its rings, and, for the chain body only, the
    capacities of its entry, stage, tap and coefficient tables (128 taps
    bound a star's radius to 31, well inside a tap's signed-byte offsets),
    their shared memory, and a thread per entry (radius-0 stages add
    entries but no halo, so a narrow block can have fewer threads).  The
    main-path body reads no table, so its ``par_time`` is bound only by
    shared memory."""
    threads = math.prod(geom.bsize)
    if threads > MAX_THREADS:
        return (f"bsize {geom.bsize} needs {threads} threads per CTA "
                f"(at most {MAX_THREADS})")
    smem = smem_bytes(geom, stages)
    if kernel_body(stages) < 0:
        entries = len(stages) * geom.par_time
        taps = sum(len(linear_taps(st) or ()) for st, _ in stages)
        coeffs = sum(len(st.coeff_names) for st, _ in stages)
        for what, n, cap in (("fused entries (stages x par_time)", entries,
                              MAX_ENTRIES),
                             ("stages", len(stages), MAX_STAGES),
                             ("taps", taps, MAX_TAPS),
                             ("coefficients", coeffs, MAX_COEFFS)):
            if n > cap:
                return f"{n} {what} exceed the kernel's table of {cap}"
        if entries > threads:
            return (f"{entries} fused entries (stages x par_time) need as "
                    f"many threads per CTA; bsize {geom.bsize} has "
                    f"{threads}")
        smem += TABLE_SMEM
    if smem > SMEM_LIMIT:
        return (f"par_time={geom.par_time}, bsize={geom.bsize} need {smem} "
                f"bytes of shared memory per CTA (at most {SMEM_LIMIT})")
    return None


def _check(stages, geom: BlockGeometry, gp, coeffs_packed, steps, aux_p,
           out):
    if not stages:
        raise ValueError("superstep_chain needs at least one stage")
    for st, bc in stages:
        if stage_op(st) is None:
            raise ValueError(
                f"the streaming kernel computes {list(KERNEL_IDS)} and "
                f"make_star/make_box tap sums; got {st.name} (ROADMAP B1i)")
        if bc is not None and not bc.is_clamp:
            raise ValueError(f"the streaming kernel supports the clamp "
                             f"boundary only; got {bc.token()} for {st.name}"
                             f" (ROADMAP B1c)")
        if st.ndim != geom.ndim:
            raise ValueError(f"{st.name} is {st.ndim}D, geometry "
                             f"{geom.ndim}D")
    rad = sum(st.radius for st, _ in stages)
    if geom.rad < rad:
        raise ValueError(f"geometry radius {geom.rad} is narrower than the "
                         f"chain's {rad}")
    if geom.par_vec != 1 or geom.ndim not in (2, 3):
        raise ValueError("the streaming kernel runs 2D/3D grids at "
                         "par_vec=1 (ROADMAP B1d)")
    limit = kernel_limits(geom, stages)
    if limit:
        raise ValueError(limit)
    shape = (geom.stream_dim,) + geom.padded_dims
    if gp.dtype != torch.float32 or tuple(gp.shape) != shape:
        raise ValueError(f"gp must be float32 of shape {shape}; got "
                         f"{gp.dtype} {tuple(gp.shape)}")
    if not gp.is_contiguous():
        raise ValueError("gp must be contiguous")
    has_aux = any(st.has_aux for st, _ in stages)
    if has_aux != (aux_p is not None):
        raise ValueError(f"the chain {'needs' if has_aux else 'takes no'} "
                         "padded aux grid")
    if aux_p is not None and (aux_p.dtype != gp.dtype
                              or aux_p.shape != gp.shape
                              or aux_p.device != gp.device
                              or not aux_p.is_contiguous()):
        raise ValueError("aux_p must be a contiguous tensor like gp")
    names = [n for st, _ in stages for n in st.coeff_names]
    if (coeffs_packed.device.type != "cpu"
            or coeffs_packed.dtype != torch.float32
            or tuple(coeffs_packed.shape) != (len(names),)):
        raise ValueError(f"coeffs_packed must be a float32 CPU vector of "
                         f"{len(names)} ({names})")
    if not 0 <= int(steps) <= geom.par_time:
        raise ValueError(f"steps={steps} outside [0, {geom.par_time}]")
    if out is not None:
        if (out.dtype != gp.dtype or out.shape != gp.shape
                or out.device != gp.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous tensor like gp")
        if out.data_ptr() in (gp.data_ptr(),
                              None if aux_p is None else aux_p.data_ptr()):
            raise ValueError("out must not alias gp or aux_p")


def superstep_chain(stages, geom: BlockGeometry, gp: torch.Tensor,
                    coeffs_packed: torch.Tensor, steps: int,
                    aux_p: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One super-step through the ``len(stages) * par_time``-entry chain of
    ``stages = ((stencil, bc), ...)``.  ``coeffs_packed`` is the float32
    CPU vector of ``kernels/ops.pack_program_coeffs``; ``steps`` a host
    int.  Returns ``out`` (allocated like ``gp`` when None) with the
    compute region of every block written; the halo and overhang columns
    are left as they were."""
    stages = tuple(stages)
    _check(stages, geom, gp, coeffs_packed, steps, aux_p, out)
    if out is None:
        out = torch.empty_like(gp)
    if gp.device.type == "cpu":
        return superstep_plain(stages, geom, gp, coeffs_packed, int(steps),
                               aux_p, out)
    if gp.device.type != "cuda":
        raise ValueError(f"no kernel for device {gp.device}")
    _launch(stages, geom, gp, coeffs_packed, int(steps), aux_p, out)
    return out


def _program_table(stages, geom: BlockGeometry, coeffs_packed):
    """The kernel's ``Program`` table for the chain: one row per unrolled
    entry (lag, producer ring, own ring, stage, iteration; rings in
    block planes, laid out in value-id order with the layout's window
    depths), one per stage (op, coefficient offset, tap range), the taps
    and the coefficients; the main-path body reads only the
    coefficients, so its entries, which may outnumber the table's rows,
    are left out.  Returns ``(table, out_lag)``."""
    plan = unroll_dag(chain_dag(stages), geom.par_time)
    lay = dag_layout(plan, 1)
    base, acc = {}, 0
    for v, w in enumerate(lay.wins):
        if w:
            base[v] = acc
            acc += w
    k = _build.Program()
    taps, lo = [], 0
    for s, (st, _) in enumerate(stages):
        pairs = linear_taps(st) or ()
        k.s[s] = _build.Stage(stage_op(st), lo, len(taps), len(pairs))
        lo += len(st.coeff_names)
        for ci, off in pairs:
            ds, dy, dx = (off[0], 0, off[1]) if geom.ndim == 2 else off
            taps.append(_build.Tap(ds, dy, dx, ci))
    for i, tap in enumerate(taps):
        k.taps[i] = tap
    for i, v in enumerate(coeffs_packed.tolist()):
        k.c[i] = v
    if kernel_body(stages) >= 0:
        return k, lay.out_lag
    F = plan.n_streams
    for i, e in enumerate(plan.entries):
        v, (p,) = F + i, e.inputs
        k.e[i] = _build.Entry(lay.lags[v], base[p], lay.wins[p],
                              base.get(v, 0), lay.wins[v], i % len(stages),
                              e.iteration)
    return k, lay.out_lag


def _launch(stages, geom, gp, coeffs_packed, steps, aux_p, out) -> None:
    global LAUNCHES
    table, out_lag = _program_table(stages, geom, coeffs_packed)
    pad, blk, cmp, dims = (geom.padded_dims, geom.bsize, geom.csize,
                           geom.blocked_dims)
    if geom.ndim == 2:      # a 2D grid is a 3D one with one blocked y row
        pad, blk, cmp, dims = ((1,) + pad, (1,) + blk, (1,) + cmp,
                               (1,) + dims)
        hy = 0
    else:
        hy = geom.size_halo
    params = _build.Params(
        ns=geom.stream_dim, ticks=geom.stream_dim + out_lag,
        py=pad[0], px=pad[1], by=blk[0], bx=blk[1], cy=cmp[0], cx=cmp[1],
        dy=dims[0], dx=dims[1], hy=hy, hx=geom.size_halo, steps=steps,
        n_entries=len(stages) * geom.par_time)
    bnum = geom.bnum
    grid_x, grid_y = bnum[-1], (bnum[0] if geom.ndim == 3 else 1)
    dll = _build.stencil_stream()
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream(gp.device).cuda_stream
        err = dll.stencil_stream_launch(
            kernel_body(stages), gp.data_ptr(),
            None if aux_p is None else aux_p.data_ptr(),
            out.data_ptr(), params, ctypes.byref(table), grid_x, grid_y,
            smem_bytes(geom, stages), stream)
    if err != 0:
        msg = dll.stencil_stream_error_string(err).decode()
        raise RuntimeError(f"stencil_stream launch failed: {msg} ({err})")
    LAUNCHES += 1


# --- plain version -----------------------------------------------------------

def _extract_blocks(gp: torch.Tensor, geom: BlockGeometry) -> torch.Tensor:
    """(ns, *padded) -> (*bnum, ns, *bsize) overlapped blocks."""
    nb = geom.ndim - 1
    out = gp
    for i in range(nb):
        c, b, n = geom.csize[i], geom.bsize[i], geom.bnum[i]
        idx = (torch.arange(n, device=gp.device)[:, None] * c
               + torch.arange(b, device=gp.device)[None, :])
        # blocked dim i sits at axis 1 + 2*i once earlier dims are expanded
        ax = 1 + 2 * i
        out = out.index_select(ax, idx.reshape(-1)).unflatten(ax, (n, b))
    perm = (tuple(1 + 2 * i for i in range(nb)) + (0,)
            + tuple(2 + 2 * i for i in range(nb)))
    return out.permute(perm)


def _edge_index(geom: BlockGeometry, i: int, device) -> torch.Tensor:
    """(bnum_i, bsize_i) block-local positions clamped to the grid along
    blocked dim ``i`` — identity on interior blocks."""
    h, c, b = geom.size_halo, geom.csize[i], geom.bsize[i]
    d = geom.blocked_dims[i]
    start = torch.arange(geom.bnum[i], device=device)[:, None] * c
    x = torch.arange(b, device=device)[None, :]
    lo = (h - start).clamp(min=0)
    hi = (d - 1 + h - start).clamp(max=b - 1)
    return torch.minimum(torch.maximum(x, lo), hi)


def _reclamp_blocks(blocks: torch.Tensor, edge_idx) -> torch.Tensor:
    """Re-impose the clamp boundary on grid-edge blocks: every blocked-axis
    position takes the value at its position clamped to the grid."""
    nb = len(edge_idx)
    for i, idx in enumerate(edge_idx):
        shape = [1] * blocks.ndim
        shape[i] = idx.shape[0]
        shape[nb + 1 + i] = idx.shape[1]
        blocks = torch.gather(blocks, nb + 1 + i,
                              idx.reshape(shape).expand(blocks.shape))
    return blocks


def _block_getter(blocks: torch.Tensor, nb: int, r: int):
    """Neighbour getter on ``(*bnum, ns, *bsize)`` blocks: stream taps clip
    to ``[0, ns-1]`` and blocked-axis taps clip to the block."""
    p = blocks
    for ax in range(nb, blocks.ndim):
        p = boundary.pad_axis(p, ax, r, r, "clamp")
    lead = (slice(None),) * nb

    def get(off):
        return p[lead + tuple(slice(r + o, r + o + n)
                              for o, n in zip(off, blocks.shape[nb:]))]
    return get


def superstep_plain(stages, geom: BlockGeometry, gp: torch.Tensor,
                    coeffs_packed: torch.Tensor, steps: int,
                    aux_p: Optional[torch.Tensor],
                    out: torch.Tensor) -> torch.Tensor:
    """The kernel's super-step in torch ops, vectorised over blocks: extract
    the overlapped blocks, run the ``len(stages) * par_time`` entries in
    order (entry ``t*S + s`` applies stage ``s`` with a getter clamped by
    that stage's radius, or forwards its input when ``t >= steps``),
    re-impose the clamp boundary on every value that feeds a next entry,
    and write each block's compute region into ``out``.  It computes the
    kernel's values without replaying its tick schedule."""
    nb = geom.ndim - 1
    h = geom.size_halo
    cdicts, lo = [], 0
    for st, _ in stages:
        n = len(st.coeff_names)
        cdicts.append(dict(zip(st.coeff_names,
                               coeffs_packed[lo:lo + n].unbind())))
        lo += n
    edge_idx = [_edge_index(geom, i, gp.device) for i in range(nb)]
    aux_b = None if aux_p is None else _extract_blocks(aux_p, geom)
    cur = _extract_blocks(gp, geom)
    n_entries = len(stages) * geom.par_time
    for i in range(n_entries):
        t, s = divmod(i, len(stages))
        st = stages[s][0]
        if t < steps:
            cur = st.apply(_block_getter(cur, nb, st.radius), cdicts[s],
                           aux_b if st.has_aux else None)
        if i < n_entries - 1:
            cur = _reclamp_blocks(cur, edge_idx)
    comp = cur[(slice(None),) * (nb + 1)
               + tuple(slice(h, h + c) for c in geom.csize)]
    # (*bnum, ns, *csize) -> (ns, bn0, cs0, bn1, cs1, ...)
    perm = (nb,) + tuple(x for i in range(nb) for x in (i, nb + 1 + i))
    widths = tuple(n * c for n, c in zip(geom.bnum, geom.csize))
    out[(slice(None),) + tuple(slice(h, h + w) for w in widths)] = (
        comp.permute(perm).reshape((geom.stream_dim,) + widths))
    return out
