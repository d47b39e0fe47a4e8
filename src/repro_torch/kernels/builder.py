"""One super-step of the streaming chain: the Hopper kernel's wrapper, its
plain version, and the launch counter.

:func:`superstep_chain` takes the padded grid ``gp`` (``(ns, *padded)``,
BC-padded by ``kernels/ops._pad_blocked``) and advances it by ``steps``
(<= ``par_time``) fused time-steps, writing the ``csize`` columns of every
block into the padded output layout.  For a CUDA tensor it launches
``csrc/stencil_stream.cu``; for a CPU tensor it runs :func:`superstep_plain`.
Nothing falls back: a CUDA tensor goes to the kernel or raises.

This slice covers the single-stage chain of the four Table-2 stencils on
2D and 3D grids, clamp boundary, float32, ``par_vec = 1``; ``api/backends``
refuses the rest at plan time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import boundary
from repro_torch.core.blocking import (MAX_THREADS, SMEM_LIMIT,
                                       BlockGeometry, smem_bytes)
from repro_torch.programs import chain_dag, dag_layout, unroll_dag

#: kernel launches made by :func:`superstep_chain` (CUDA tensors only)
LAUNCHES = 0

#: stencil name -> ``stencil_id`` of ``stencil_stream_launch``
KERNEL_IDS = {"diffusion2d": 0, "hotspot2d": 1, "diffusion3d": 2,
              "hotspot3d": 3}


def kernel_limits(geom: BlockGeometry) -> Optional[str]:
    """Why the kernel cannot run ``geom`` (None if it can): one thread per
    block-plane cell and :func:`smem_bytes` of shared memory per CTA."""
    threads = math.prod(geom.bsize)
    if threads > MAX_THREADS:
        return (f"bsize {geom.bsize} needs {threads} threads per CTA "
                f"(at most {MAX_THREADS})")
    smem = smem_bytes(geom)
    if smem > SMEM_LIMIT:
        return (f"par_time={geom.par_time}, bsize={geom.bsize} need {smem} "
                f"bytes of shared memory per CTA (at most {SMEM_LIMIT})")
    return None


def _check(stages, geom: BlockGeometry, gp, coeffs_packed, steps, aux_p,
           out):
    if len(stages) != 1:
        raise NotImplementedError("multi-stage chains are not ported yet "
                                  "(ROADMAP B1g)")
    st, bc = stages[0]
    if st.name not in KERNEL_IDS or st.radius != 1:
        raise ValueError(f"the streaming kernel computes {list(KERNEL_IDS)};"
                         f" got {st.name}")
    if bc is not None and not bc.is_clamp:
        raise ValueError(f"the streaming kernel supports the clamp boundary "
                         f"only; got {bc.token()} (ROADMAP B1c)")
    if geom.par_vec != 1 or geom.ndim not in (2, 3):
        raise ValueError("the streaming kernel runs 2D/3D grids at "
                         "par_vec=1 (ROADMAP B1d)")
    if st.ndim != geom.ndim:
        raise ValueError(f"{st.name} is {st.ndim}D, geometry {geom.ndim}D")
    limit = kernel_limits(geom)
    if limit:
        raise ValueError(limit)
    shape = (geom.stream_dim,) + geom.padded_dims
    if gp.dtype != torch.float32 or tuple(gp.shape) != shape:
        raise ValueError(f"gp must be float32 of shape {shape}; got "
                         f"{gp.dtype} {tuple(gp.shape)}")
    if not gp.is_contiguous():
        raise ValueError("gp must be contiguous")
    if st.has_aux != (aux_p is not None):
        raise ValueError(f"{st.name} {'needs' if st.has_aux else 'takes no'}"
                         " padded aux grid")
    if aux_p is not None and (aux_p.dtype != gp.dtype
                              or aux_p.shape != gp.shape
                              or aux_p.device != gp.device
                              or not aux_p.is_contiguous()):
        raise ValueError("aux_p must be a contiguous tensor like gp")
    if (coeffs_packed.device.type != "cpu"
            or coeffs_packed.dtype != torch.float32
            or tuple(coeffs_packed.shape) != (len(st.coeff_names),)):
        raise ValueError(f"coeffs_packed must be a float32 CPU vector of "
                         f"{len(st.coeff_names)} ({st.coeff_names})")
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
    """One super-step through the ``par_time``-entry chain of
    ``stages = ((stencil, bc),)``.  ``coeffs_packed`` is the float32 CPU
    vector of ``kernels/ops.pack_coeffs``; ``steps`` a host int.  Returns
    ``out`` (allocated like ``gp`` when None) with the compute region of
    every block written; the halo and overhang columns are left as they
    were."""
    _check(stages, geom, gp, coeffs_packed, steps, aux_p, out)
    if out is None:
        out = torch.empty_like(gp)
    if gp.device.type == "cpu":
        return superstep_plain(stages[0][0], geom, gp, coeffs_packed,
                               int(steps), aux_p, out)
    if gp.device.type != "cuda":
        raise ValueError(f"no kernel for device {gp.device}")
    _launch(stages, geom, gp, coeffs_packed, int(steps), aux_p, out)
    return out


def _launch(stages, geom, gp, coeffs_packed, steps, aux_p, out) -> None:
    global LAUNCHES
    from repro_torch.kernels import _build
    st = stages[0][0]
    # the kernel's rings are the layout's windows (smem_bytes counts them)
    lay = dag_layout(unroll_dag(chain_dag(stages), geom.par_time), 1)
    pad, blk, cmp, dims = (geom.padded_dims, geom.bsize, geom.csize,
                           geom.blocked_dims)
    if geom.ndim == 2:      # a 2D grid is a 3D one with one blocked y row
        pad, blk, cmp, dims = ((1,) + pad, (1,) + blk, (1,) + cmp,
                               (1,) + dims)
        hy = 0
    else:
        hy = geom.size_halo
    params = _build.Params(
        ns=geom.stream_dim, ticks=geom.stream_dim + lay.out_lag,
        py=pad[0], px=pad[1], by=blk[0], bx=blk[1], cy=cmp[0], cx=cmp[1],
        dy=dims[0], dx=dims[1], hy=hy, hx=geom.size_halo,
        par_time=geom.par_time, steps=steps)
    coeffs = _build.Coeffs()
    for i, v in enumerate(coeffs_packed.tolist()):
        coeffs.c[i] = v
    bnum = geom.bnum
    grid_x, grid_y = bnum[-1], (bnum[0] if geom.ndim == 3 else 1)
    dll = _build.stencil_stream()
    with torch.cuda.device(gp.device):
        stream = torch.cuda.current_stream(gp.device).cuda_stream
        err = dll.stencil_stream_launch(
            KERNEL_IDS[st.name], gp.data_ptr(),
            None if aux_p is None else aux_p.data_ptr(), out.data_ptr(),
            params, coeffs, grid_x, grid_y, smem_bytes(geom), stream)
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


def superstep_plain(stencil, geom: BlockGeometry, gp: torch.Tensor,
                    coeffs_packed: torch.Tensor, steps: int,
                    aux_p: Optional[torch.Tensor],
                    out: torch.Tensor) -> torch.Tensor:
    """The kernel's super-step in torch ops, vectorised over blocks: extract
    the overlapped blocks, run ``par_time`` entries (an entry past ``steps``
    forwards its input), re-impose the clamp boundary on every value that
    feeds a next entry, and write each block's compute region into ``out``.
    It computes the kernel's values without replaying its tick schedule."""
    nb = geom.ndim - 1
    h = geom.size_halo
    coeffs = dict(zip(stencil.coeff_names, coeffs_packed.unbind()))
    edge_idx = [_edge_index(geom, i, gp.device) for i in range(nb)]
    aux_b = None if aux_p is None else _extract_blocks(aux_p, geom)
    cur = _extract_blocks(gp, geom)
    for t in range(geom.par_time):
        if t < steps:
            cur = stencil.apply(_block_getter(cur, nb, stencil.radius),
                                coeffs, aux_b)
        if t < geom.par_time - 1:
            cur = _reclamp_blocks(cur, edge_idx)
    comp = cur[(slice(None),) * (nb + 1)
               + tuple(slice(h, h + c) for c in geom.csize)]
    # (*bnum, ns, *csize) -> (ns, bn0, cs0, bn1, cs1, ...)
    perm = (nb,) + tuple(x for i in range(nb) for x in (i, nb + 1 + i))
    widths = tuple(n * c for n, c in zip(geom.bnum, geom.csize))
    out[(slice(None),) + tuple(slice(h, h + w) for w in widths)] = (
        comp.permute(perm).reshape((geom.stream_dim,) + widths))
    return out
