"""One super-step of the streaming kernel: its wrappers, their plain
versions, and the launch counter.

:func:`superstep_chain` takes the padded grid ``gp`` (``(ns, *padded)``,
BC-padded by ``kernels/ops._pad_blocked``) and advances it by ``steps``
(<= ``par_time``) fused iterations of the stage chain ``stages = ((stencil,
bc), ...)``, writing the ``csize`` columns of every block into the padded
output layout.  The ``len(stages) * par_time`` unrolled entries run in
order; an entry whose iteration is ``>= steps`` forwards its input (PE
forwarding).  :func:`superstep_dag` does the same for a stage DAG
(``programs.DagSpec``: several fields, fan-out, fan-in, state nodes) over
the padded state, ``(F, ns, *padded)`` for ``F > 1`` fields.  ``ns`` is the
stream extent, the periodic stream extension included.  Either takes a
batch of states with a leading batch axis, ``(B, ns, *padded)`` or ``(B,
F, ns, *padded)``, and advances all ``B`` members in one launch (the
members run along the kernel grid's z axis, at most
``_build.MAX_BATCH``); the aux grid is then one field's, shared by the
batch, or one per member.  Every launch cuts the stream into segments,
each streamed by its own CTA of every block after a warm-up
(:func:`segment_plan`, :class:`StreamSplit`).  A DAG at ``par_vec = 1``
runs the DAG bodies' one-barrier form, laid out by :func:`win_layout`
(lags that keep every cross-thread read a tick behind its write, state
nodes as aliases, own-cell values in registers), and a chain at
``par_vec = 1`` the chain body's, laid out by :func:`chain_layout` (the
field stream copied ahead, own-column rows in registers), unless
:func:`win_form` names why it takes a per-entry-barrier form.  For a
CUDA tensor
they launch ``csrc/stencil_stream.cu``; for a CPU tensor they run
:func:`superstep_plain` / :func:`superstep_dag_plain`.  Nothing falls back:
a CUDA tensor goes to the kernel or raises.

The kernel computes a stage with one of four ops: the device function of
a Table-2 stencil (:data:`KERNEL_IDS`), a tap table for a stencil whose
``apply`` is an ordered tap sum (``make_star``/``make_box``,
:func:`linear_taps`), the weighted sum of a ``make_combine``, or, for any
other stencil, a device function that ``kernels/codegen.py`` writes from
its own ``apply`` (:data:`CUSTOM_OP`); a DAG's state nodes select.  A
program with custom stencils runs a library of its own, built from the
generated header at its first launch (``_build.custom_stencil_stream``).
An ``apply`` that cannot be lowered is refused as ROADMAP B1i-ops.  This
slice covers such programs on 1D, 2D and 3D
grids, the four boundary kinds per axis and per stage (a DAG whose stages
differ runs the kernel's mixed-boundary body, whose consumers re-impose at
read time), block planes of any size (over 1024 cells a thread takes
several), tables past the kernel parameter's capacities (in a device
buffer), float32 or bfloat16 storage with float32 arithmetic (one
rounding to storage per stage application), any ``par_vec``: one tick
streams a slab of ``par_vec`` rows (planes in 3D), and the stream axis is
padded to a slab multiple.  Rows at or past the real stream extent ``dom``
(the grid's, plus the periodic extension) are never tapped: a stream tap
outside ``[0, dom-1]`` clips, mirrors or reads the fill by the tapping
stage's stream-axis kind, and neither the kernel nor its plain version
writes those rows.  ``api/backends`` refuses the rest at plan time.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.core import boundary, precision
from repro_torch.core.blocking import (MAX_THREADS, SMEM_LIMIT,
                                       BlockGeometry, smem_bytes,
                                       stream_extension)
from repro_torch.core.stencils import STENCILS, Stencil, make_star
from repro_torch.kernels import _build, codegen
from repro_torch.kernels._build import (BYTE_MAX, MAX_BATCH, MAX_COEFFS,
                                        MAX_ENTRIES, MAX_FIELDS, MAX_INPUTS,
                                        MAX_STAGES, MAX_TAPS, SHORT_MAX,
                                        TABLE_SMEM, big_table_bytes)
from repro_torch.programs import (DagSpec, chain_dag, dag_is_chain,
                                  dag_layout, dag_radius, unroll_dag)

#: kernel launches made by :func:`superstep_chain` and :func:`superstep_dag`
#: (CUDA tensors only); counted under a lock, since the service launches
#: from worker threads; and the same launches per kernel, named as
#: :attr:`StreamSplit.kernel` names it
LAUNCHES = 0
KERNEL_LAUNCHES: dict = {}
_LAUNCHES_LOCK = threading.Lock()

#: Table-2 stencil name -> its op id in ``stencil_stream.cu``
KERNEL_IDS = {"diffusion2d": 0, "hotspot2d": 1, "diffusion3d": 2,
              "hotspot3d": 3}
#: op ids of the tap-table path, the combine and a custom ``apply``
TAP_OP, COMBINE_OP, CUSTOM_OP = 4, 5, 6
#: ``stencil_stream.cu``'s table-driven bodies: any chain, a DAG whose
#: stages share one boundary, and any DAG (the main-path body runs a
#: Table-2 id)
CHAIN_BODY, DAG_BODY, MIX_BODY = -1, -2, -3
#: boundary kind -> its id in ``stencil_stream.cu``'s ``Stage`` table
#: (``Kind``); an axis the grid does not have is "periodic", which
#: re-imposes nothing
BC_IDS = {"clamp": 0, "periodic": 1, "reflect": 2, "constant": 3}
#: the storage dtypes the kernel runs (float32 arithmetic for both)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def linear_taps(stencil: Stencil):
    """The ordered ``(coefficient index, offset)`` pairs of a stencil whose
    ``apply`` is a tap sum, in the order ``apply`` adds them; ``None`` for
    any other stencil."""
    if not stencil.tap_sum or stencil.arity != 1 or stencil.has_aux:
        return None
    return tuple(enumerate(stencil.offsets))


def stage_op(stencil: Stencil) -> int:
    """The kernel op that computes ``stencil``: a Table-2 id,
    :data:`TAP_OP`, :data:`COMBINE_OP` or, for any other stencil whose
    ``apply`` traces (``codegen.trace``), :data:`CUSTOM_OP`.  Raises
    ``ValueError`` naming ROADMAP B1i-ops for one that does not."""
    if stencil.name in KERNEL_IDS and STENCILS[stencil.name] == stencil:
        return KERNEL_IDS[stencil.name]
    if linear_taps(stencil) is not None:
        return TAP_OP
    if (stencil.combine and not stencil.has_aux
            and len(stencil.coeff_names) == stencil.arity):
        return COMBINE_OP
    codegen.trace(stencil)
    return CUSTOM_OP


def custom_stencils(stages) -> tuple:
    """The distinct stencils of ``((stencil, bc), ...)`` that run as
    :data:`CUSTOM_OP`, in stage order: the program's generated header
    holds the device function of the ``k``-th as its function ``k``."""
    return tuple(dict.fromkeys(st for st, _ in stages
                               if stage_op(st) == CUSTOM_OP))


def _as_chain(program):
    """The ``((stencil, bc), ...)`` stages of a chain (a stage tuple or a
    path-graph ``DagSpec``), or None for any other DAG."""
    if not isinstance(program, DagSpec):
        return tuple(program)
    if dag_is_chain(program):
        return tuple((st, bc) for st, bc, _ in program.stages)
    return None


def is_main_path(program) -> bool:
    """Whether ``program`` (a chain ``((stencil, bc), ...)`` or a
    ``DagSpec``) is one Table-2 stage, which the main-path body runs."""
    stages = _as_chain(program)
    return (stages is not None and len(stages) == 1
            and stages[0][0].name in KERNEL_IDS
            and STENCILS[stages[0][0].name] == stages[0][0])


def kernel_body(stages) -> int:
    """Which loop body of the kernel runs the chain: the Table-2 id for a
    single Table-2 stage (the paper's main path), else :data:`CHAIN_BODY`
    (any chain)."""
    if is_main_path(stages):
        return KERNEL_IDS[stages[0][0].name]
    return CHAIN_BODY


def cta_shape(geom: BlockGeometry, tab: Optional["Tables"] = None) -> tuple:
    """``(vt, rows, threads)`` of one CTA of the kernel running a program
    whose tables are ``tab`` (None for the main-path body), the rule of
    ``stencil_stream.cu``'s ``cta_threads``: for a table-driven body
    ``vt`` the largest divisor of ``par_vec`` with ``prod(bsize) * vt <=
    1024``, so ``vt`` rows of a slab are computed at once and each thread
    takes ``rows = par_vec / vt`` of them; ``threads`` is ``plane * vt``,
    and at least the body's entries (one thread builds each entry's tick
    record), rounded up to a multiple of 32.  The main-path body takes
    every row of a slab per thread (``vt = 1``: its threads keep the
    stream-axis taps of their own column).  A block plane over 1024
    cells, and the large-table route at any plane, run the kernel's wide
    form: ``vt = 1``, every row of a slab per thread, and ``min(plane,
    1024)`` threads rounded up to 32, each taking every ``threads``-th
    cell of the plane (and, in the large-table route, every
    ``threads``-th entry's records)."""
    plane, V = math.prod(geom.bsize), geom.par_vec
    if (tab is not None and tab.big) or plane > MAX_THREADS:
        return 1, V, min(-(-plane // 32) * 32, MAX_THREADS)
    vt = 1 if tab is None else max(
        d for d in range(1, V + 1) if V % d == 0 and plane * d <= MAX_THREADS)
    threads = -(-max(plane * vt, tab.entries if tab else 0) // 32) * 32
    return vt, V // vt, threads


#: the main path's register form: the most entries whose stream-axis
#: windows a thread keeps in registers, the most it keeps in a plane of
#: over 512 cells (its CTA then has up to 1024 threads of at most 64
#: registers), and the most slabs of the field stream its copies run
#: ahead (``stencil_stream.cu``'s ``kMaxWindowEntries``,
#: ``kMaxWideWindowEntries``, ``kMaxLook``)
WINDOW_ENTRIES, WIDE_WINDOW_ENTRIES, MAX_LOOK = 16, 8, 4


def _plane_rows(geom: BlockGeometry) -> tuple:
    """``(by, bx)``: the block plane as the kernel sees it (a 2D block is
    one row; a 1D one a single cell)."""
    if geom.ndim == 3:
        return tuple(geom.bsize)
    return (1, geom.bsize[0] if geom.ndim == 2 else 1)


def _stream_rows(geom: BlockGeometry, cell_bytes: int) -> tuple:
    """``(by, srow)``: the rows of a staged slot of the field stream and
    the cells between them (in bfloat16 ``bx`` plus two rounded up to an
    even count: a row is staged from the 4-byte word that holds its first
    cell)."""
    by, bx = _plane_rows(geom)
    return by, bx if cell_bytes == 4 else (bx + 3) & ~1


def window_smem(geom: BlockGeometry, look: int, cell_bytes: int) -> int:
    """Shared memory of the main path's register form with ``look`` slabs
    copied ahead: ``look + 2`` staged slots of the block's rows (in
    bfloat16 each row ``bx`` plus two cells rounded up to an even count:
    a row is staged from the 4-byte word that holds its first cell), and
    two block planes per entry with a consumer."""
    by, srow = _stream_rows(geom, cell_bytes)
    return ((look + 2) * by * srow
            + 2 * (geom.par_time - 1) * math.prod(geom.bsize)) * cell_bytes


def whole_word_rows(geom: BlockGeometry, cell_bytes: int) -> bool:
    """Whether every stream row of the padded grid starts on the same half
    of a 4-byte word as the first, as the copies ahead of the main path's
    register form and of the chain body's one-barrier form need (each copy
    is a whole word, laid out from the first row's shift): always in
    float32; in bfloat16 only when a padded plane holds an even count of
    cells (a 1D grid's plane is one cell)."""
    return cell_bytes == 4 or math.prod(geom.padded_dims) % 2 == 0


def main_look(geom: BlockGeometry, cell_bytes: int = 4) -> int:
    """The slabs the main path's register form copies ahead at ``geom``,
    or 0 for its ring form.  The register form runs one cell a thread at
    ``par_vec = 1`` with at most :data:`WINDOW_ENTRIES` entries (at most
    :data:`WIDE_WINDOW_ENTRIES` in a plane of over 512 cells), copying
    ``min(par_time, MAX_LOOK)`` slabs ahead, fewer where shared memory is
    short; the rest (``par_vec > 1``, the wide form, more entries, a
    bfloat16 stream whose rows do not start on one half of a 4-byte word
    (:func:`whole_word_rows`), or no look-ahead that fits) run the ring
    form, whose shared memory is the layout's ``3 * par_time`` slabs."""
    plane = math.prod(geom.bsize)
    if (geom.par_vec != 1 or geom.par_time > WINDOW_ENTRIES
            or plane > (512 if geom.par_time > WIDE_WINDOW_ENTRIES
                        else MAX_THREADS)
            or not whole_word_rows(geom, cell_bytes)):
        return 0
    for look in range(min(geom.par_time, MAX_LOOK), 0, -1):
        if window_smem(geom, look, cell_bytes) <= SMEM_LIMIT:
            return look
    return 0


def main_smem(geom: BlockGeometry, cell_bytes: int = 4) -> Optional[int]:
    """Shared memory of the main-path body at ``geom``: the register
    form's (:func:`window_smem`), or None for the ring form, whose rings
    are the layout's (``core/blocking.smem_bytes``)."""
    look = main_look(geom, cell_bytes)
    return window_smem(geom, look, cell_bytes) if look else None


def _bc_key(bc, ndim: int) -> tuple:
    """What a stage's boundary does: its kinds, and its fill where an axis
    is constant."""
    kinds = boundary.kinds_of(bc, ndim)
    return kinds, boundary.fill_of(bc) if "constant" in kinds else 0.0


def mixes_boundaries(dag: DagSpec, ndim: int) -> bool:
    """Whether the stages of ``dag`` differ in boundary (a kind on some
    axis, or the fill): the kernel then runs its mixed-boundary DAG body,
    whose consumers re-impose at read time (a path graph runs the chain
    body, which takes every value's one consumer's boundary at push
    time)."""
    return len({_bc_key(bc, ndim) for _, bc, _ in dag.stages}) > 1


class Tables(NamedTuple):
    """What the tables of a table-driven body hold for one program:
    ``body`` ("chain" or "dag"), unrolled entries, stages, taps,
    coefficients, field streams, the widest entry's inputs, the inputs of
    all entries, the rings' slots and the largest lag (in slabs of
    ``par_vec`` rows), and the farthest tap offset."""
    body: str
    entries: int
    stages: int
    taps: int
    coeffs: int
    fields: int
    inputs: int
    all_inputs: int
    slots: int
    lag: int
    reach: int

    @property
    def big(self) -> bool:
        """Past a capacity of the kernel parameter's ``Program`` (its
        lengths, or its 16-bit lags and ring slots and 8-bit tap offsets):
        the large-table route (the table in a device buffer with 32-bit
        fields, the records in dynamic shared memory sized to the
        program)."""
        return (self.entries > MAX_ENTRIES or self.stages > MAX_STAGES
                or self.taps > MAX_TAPS or self.coeffs > MAX_COEFFS
                or self.fields > MAX_FIELDS or self.inputs > MAX_INPUTS
                or max(self.slots, self.lag) > SHORT_MAX
                or self.reach > BYTE_MAX)

    @property
    def smem(self) -> int:
        """Shared memory of the records, taps and coefficients: static and
        sized to the caps, or, in the large-table route, sized to the
        program."""
        if not self.big:
            return TABLE_SMEM[self.body]
        return big_table_bytes(self.body, self.entries, self.taps,
                               self.coeffs, self.all_inputs)


def tables_of(geom: BlockGeometry, program) -> Optional[Tables]:
    """:class:`Tables` of ``program`` (a chain ``((stencil, bc), ...)`` or
    a ``DagSpec``) at ``geom``; None for a single Table-2 stage, whose
    main-path body reads no table."""
    stages = _as_chain(program)
    if stages is not None and kernel_body(stages) >= 0:
        return None
    return _tables(geom, program if isinstance(program, DagSpec)
                   else chain_dag(stages))


@functools.lru_cache(maxsize=256)
def _tables(geom: BlockGeometry, dag: DagSpec) -> Tables:
    plan = unroll_dag(dag, geom.par_time)
    lay = dag_layout(plan, geom.par_vec)
    stencils = [st for st, _, _ in dag.stages]
    taps = [linear_taps(st) or () for st in stencils]
    return Tables(
        "chain" if dag_is_chain(dag) else "dag", len(plan.entries),
        len(stencils), sum(map(len, taps)),
        sum(len(st.coeff_names) for st in stencils), dag.n_fields,
        max(len(e.inputs) for e in plan.entries),
        sum(len(e.inputs) for e in plan.entries), sum(lay.wins),
        max(lay.lags), max((abs(o) for t in taps for _, off in t
                            for o in off), default=0))


def kernel_limits(geom: BlockGeometry, program,
                  cell_bytes: int = 4) -> Optional[str]:
    """Why the kernel cannot run ``program`` (the chain ``((stencil, bc),
    ...)`` or a ``DagSpec``) at ``geom`` with ``cell_bytes`` of storage a
    cell (None if it can): per CTA the :func:`smem_bytes` of its rings
    (``par_vec`` rows per slot) and, for the table-driven bodies (any
    chain but one Table-2 stage, any DAG), the shared memory of their
    records, taps and coefficients (:class:`Tables`; a program past the
    kernel parameter's capacities takes the large-table route, whose
    records are sized to it) must fit one CTA.  Any block plane runs (over
    1024 cells in the wide form, :func:`cta_shape`), and DAGs whose stages
    differ in boundary run the mixed-boundary body.  The main-path body
    reads no table, so its ``par_time`` is bound only by shared memory."""
    smem = smem_bytes(geom, program, cell_bytes)
    tab = tables_of(geom, program)
    if tab is not None:
        smem += tab.smem
    if smem > SMEM_LIMIT:
        return (f"par_time={geom.par_time}, bsize={geom.bsize}, "
                f"par_vec={geom.par_vec} need {smem} bytes of shared memory "
                f"per CTA at {cell_bytes} bytes a cell (at most "
                f"{SMEM_LIMIT})")
    return None


def _check_stages(stages, geom: BlockGeometry, rad: int) -> None:
    """What the kernel needs of ``((stencil, bc), ...)`` at ``geom``."""
    for st, bc in stages:
        stage_op(st)
        if st.ndim != geom.ndim:
            raise ValueError(f"{st.name} is {st.ndim}D, geometry "
                             f"{geom.ndim}D")
    if len({tuple(k == "periodic" for k in boundary.kinds_of(bc, geom.ndim))
            for _, bc in stages}) > 1:
        raise ValueError("periodicity must be uniform across the stages")
    if geom.rad < rad:
        raise ValueError(f"geometry radius {geom.rad} is narrower than the "
                         f"program's {rad}")
    if geom.ndim not in (1, 2, 3):
        raise ValueError(f"the streaming kernel runs 1D, 2D and 3D grids; "
                         f"got {geom.ndim}D")


def check_batch(batch: int) -> None:
    """Raise unless one launch can advance ``batch`` members: 1 to
    ``MAX_BATCH``, the cap of the kernel grid's z axis."""
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"a batch of {batch} members: one stencil_stream "
                         f"launch advances 1 to {MAX_BATCH} (the gridDim.z "
                         f"cap); split the batch")


def batch_of(shape, gp) -> Optional[int]:
    """``B`` when ``gp`` carries a leading batch axis in front of the
    padded state ``shape``, else None."""
    return gp.shape[0] if gp.ndim == len(shape) + 1 else None


def _check_tensors(shape, n_coeffs: int, geom: BlockGeometry, gp,
                   coeffs_packed, steps, aux_p, has_aux: bool,
                   out) -> Optional[int]:
    """``gp`` (and ``out``) of ``shape`` or ``(B, *shape)`` and a storage
    dtype the kernel runs, ``aux_p`` of one field's shape, or of ``(B,
    *field)`` for a batch, and the same dtype.  Returns ``B`` (None
    unbatched); the batch cap is checked before the layout, so that a
    refused batch is named as such."""
    batch = batch_of(shape, gp)
    want = shape if batch is None else (batch,) + tuple(shape)
    if gp.dtype not in KERNEL_DTYPES or tuple(gp.shape) != want:
        raise ValueError(f"gp must be float32 or bfloat16 of shape {shape} "
                         f"or (B, *{shape}); got {gp.dtype} "
                         f"{tuple(gp.shape)}")
    if batch is not None:
        check_batch(batch)
    if not gp.is_contiguous():
        raise ValueError("gp must be contiguous")
    if has_aux != (aux_p is not None):
        raise ValueError(f"the program {'needs' if has_aux else 'takes no'}"
                         " padded aux grid")
    field = tuple(gp.shape[-geom.ndim:])
    if aux_p is not None and (
            aux_p.dtype != gp.dtype
            or tuple(aux_p.shape) not in (field, (batch,) + field)
            or aux_p.device != gp.device or not aux_p.is_contiguous()):
        raise ValueError("aux_p must be a contiguous tensor like one field "
                         "of gp, or one per member of the batch")
    if (coeffs_packed.device.type != "cpu"
            or coeffs_packed.dtype != torch.float32
            or tuple(coeffs_packed.shape) != (n_coeffs,)):
        raise ValueError(f"coeffs_packed must be a float32 CPU vector of "
                         f"{n_coeffs}")
    if not 0 <= int(steps) <= geom.par_time:
        raise ValueError(f"steps={steps} outside [0, {geom.par_time}]")
    if out is not None:
        if (out.dtype != gp.dtype or out.shape != gp.shape
                or out.device != gp.device or not out.is_contiguous()):
            raise ValueError("out must be a contiguous tensor like gp")
        if out.data_ptr() in (gp.data_ptr(),
                              None if aux_p is None else aux_p.data_ptr()):
            raise ValueError("out must not alias gp or aux_p")
    return batch


def _stream_dom(geom: BlockGeometry, bc0) -> int:
    """The real stream extent: the grid's, plus the periodic extension."""
    return geom.stream_dim + 2 * stream_extension(geom, bc0)


def _stream_shape(geom: BlockGeometry, bc0, n_fields: int = 1) -> tuple:
    """The padded state's shape: the stream axis carries the periodic
    extension and is padded to a multiple of ``par_vec``."""
    ns = geom.stream_slabs(_stream_dom(geom, bc0)) * geom.par_vec
    return (((n_fields,) if n_fields > 1 else ()) + (ns,)
            + geom.padded_dims)


def superstep_chain(stages, geom: BlockGeometry, gp: torch.Tensor,
                    coeffs_packed: torch.Tensor, steps: int,
                    aux_p: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None,
                    _segments: Optional[int] = None) -> torch.Tensor:
    """One super-step through the ``len(stages) * par_time``-entry chain of
    ``stages = ((stencil, bc), ...)``: :func:`superstep_dag` of its path
    graph.  ``coeffs_packed`` is the float32 CPU vector of
    ``kernels/ops.pack_program_coeffs``; ``steps`` a host int."""
    stages = tuple(stages)
    if not stages:
        raise ValueError("superstep_chain needs at least one stage")
    many = [st.name for st, _ in stages if st.arity != 1]
    if many:
        raise ValueError(f"a stencil of several inputs runs in a DAG "
                         f"(superstep_dag), not in a chain, whose stages "
                         f"read one; got {many}")
    return superstep_dag(chain_dag(stages), geom, gp, coeffs_packed, steps,
                         aux_p, out, _segments)


def superstep_dag(dag: DagSpec, geom: BlockGeometry, gp: torch.Tensor,
                  coeffs_packed: torch.Tensor, steps: int,
                  aux_p: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  _segments: Optional[int] = None) -> torch.Tensor:
    """One super-step (<= ``par_time`` fused program iterations) of the
    stage DAG ``dag`` over the padded state ``gp``: ``(ns, *padded)`` for
    one field, ``(F, ns, *padded)`` for ``F`` (each field padded under
    stage 0's BC by ``kernels/ops._pad_blocked``).  ``coeffs_packed`` is
    ``kernels/ops.pack_dag_coeffs``' float32 CPU vector; ``steps`` a host
    int.  A leading batch axis, ``(B, *state)``, advances ``B`` members in
    one launch, with ``aux_p`` one field's shape (shared) or ``(B,
    *field)``.  A path graph runs the kernel's chain (or main-path) body,
    any other DAG its DAG body.  Returns ``out`` (allocated like ``gp`` when
    None) with the compute region of every block of every field written,
    rows ``< dom`` of the stream; the halo and overhang columns and the
    slab-pad rows are left as they were.  ``_segments`` (tests only) cuts
    the stream into about that many segments in place of
    :func:`segment_plan`'s count."""
    pairs = tuple((st, bc) for st, bc, _ in dag.stages)
    _check_stages(pairs, geom, dag_radius(dag))
    limit = kernel_limits(geom, dag, gp.element_size())
    if limit:
        raise ValueError(limit)
    batch = _check_tensors(_stream_shape(geom, pairs[0][1], dag.n_fields),
                           sum(len(st.coeff_names) for st, _ in pairs), geom,
                           gp, coeffs_packed, steps, aux_p,
                           any(st.has_aux for st, _ in pairs), out)
    if out is None:
        out = torch.empty_like(gp)
    if gp.device.type == "cpu":
        return superstep_dag_plain(dag, geom, gp, coeffs_packed, int(steps),
                                   aux_p, out)
    if gp.device.type != "cuda":
        raise ValueError(f"no kernel for device {gp.device}")
    cell_bytes = gp.element_size()
    prog = _prepared(dag, geom, tuple(coeffs_packed.tolist()), gp.device,
                     cell_bytes)
    smem = launch_smem(dag, geom, cell_bytes)
    _launch(dag, prog, geom, gp, aux_p, out, int(steps), smem, batch,
            _segments)
    return out


# --- the kernel's tables and launch ------------------------------------------

def _ring_bases(wins) -> dict:
    """Value id -> its ring's first slot: rings laid out in value-id order
    with the layout's window depths."""
    base, acc = {}, 0
    for v, w in enumerate(wins):
        if w:
            base[v] = acc
            acc += w
    return base


def _fill_entries(k, rows, big: bool) -> None:
    """Fill the entry table of ``k`` from ``(lag, stage, iteration, field,
    out_base, out_slots, ins)`` rows, ``ins`` the ``(ring base, slots)``
    of each input: inline in ``Entry``, or, in the large-table route, in
    the table's ``ins`` from the entry's ``in_lo`` on."""
    lo = 0
    for i, (*head, ins) in enumerate(rows):
        if big:
            k.e[i] = _build.BigEntry(*head, len(ins), lo)
            for base, slots in ins:
                k.ins[lo] = _build.Input(base, slots)
                lo += 1
        else:
            bases, slots = zip(*(list(ins)
                                 + [(0, 0)] * (MAX_INPUTS - len(ins))))
            k.e[i] = _build.Entry(*head, len(ins), 0, bases, slots)


def _stage_tables(k, stages, ndim: int, coeffs_packed) -> None:
    """Fill the stage, tap and coefficient tables of ``k`` from ``((stencil,
    bc), ...)``: per stage its op, coefficient offset, tap range (a custom
    stage's function index and 0), boundary kinds (stream, blocked y,
    blocked x) and fill; the taps of every tap table; the coefficients."""
    taps, lo = [], 0
    customs = custom_stencils(stages)
    for s, (st, bc) in enumerate(stages):
        pairs = linear_taps(st) or ()
        kinds = boundary.kinds_of(bc, ndim)
        blocked = ("periodic",) * (3 - ndim) + tuple(kinds[1:])
        op = stage_op(st)
        # a custom stage's tap range holds its function index
        k.s[s] = _build.Stage(op, lo, customs.index(st) if op == CUSTOM_OP
                              else len(taps), len(pairs),
                              *(BC_IDS[x] for x in (kinds[0],) + blocked), 0,
                              boundary.fill_of(bc))
        lo += len(st.coeff_names)
        for ci, off in pairs:
            ds, dy, dx = ((off[0], 0, 0) if ndim == 1 else
                          (off[0], 0, off[1]) if ndim == 2 else off)
            taps.append((ds, dy, dx, ci))
    for i, tap in enumerate(taps):
        k.taps[i] = k.taps._type_(*tap)   # Tap, or BigTap
    for i, v in enumerate(coeffs_packed.tolist()):
        k.c[i] = v


def _new_table(tab: Tables, big: bool):
    """An empty table for a program of ``tab``: ``Program`` (the kernel
    parameter, sized to its capacities) or, for the large-table route
    (``big``), one with tables of the program's lengths
    (``_build.program_type``)."""
    if not big:
        return _build.Program()
    return _build.program_type(tab.entries, tab.stages, tab.taps, tab.coeffs,
                               tab.fields, tab.all_inputs)()


def _program_table(stages, geom: BlockGeometry, coeffs_packed,
                   big: bool = False):
    """The kernel's ``Program`` table for the chain: one row per unrolled
    entry (lag, producer ring, own ring, stage, iteration; lags and rings
    in slabs of ``par_vec`` block planes, rings laid out in value-id order
    with the layout's window depths), one per stage (op, coefficient
    offset, tap range), the taps and the coefficients; the main-path body
    reads only the coefficients, so its entries, which may outnumber the
    table's rows, are left out.  ``big``: sized to the program, for the
    large-table route.  Returns ``(table, out_lag)``."""
    plan = unroll_dag(chain_dag(stages), geom.par_time)
    lay = dag_layout(plan, geom.par_vec)
    base = _ring_bases(lay.wins)
    if kernel_body(stages) >= 0:
        k = _build.Program()
        _stage_tables(k, stages, geom.ndim, coeffs_packed)
        return k, lay.out_lag
    k = _new_table(tables_of(geom, stages), big)
    _stage_tables(k, stages, geom.ndim, coeffs_packed)
    F = plan.n_streams
    _fill_entries(k, [(lay.lags[F + i], i % len(stages), e.iteration, -1,
                       base.get(F + i, 0), lay.wins[F + i],
                       [(base[p], lay.wins[p]) for p in e.inputs])
                      for i, e in enumerate(plan.entries)], big)
    return k, lay.out_lag


def _dag_table(dag: DagSpec, geom: BlockGeometry, coeffs_packed,
               big: bool = False):
    """The kernel's ``Program`` table for a DAG: as :func:`_program_table`,
    with every input's ring per entry, stage -1 for a state node, the
    output field each value drains to, and per field stream its ring and
    whether the field is carried unchanged.  Returns ``(table, out_lag,
    n_entries)``."""
    plan = unroll_dag(dag, geom.par_time)
    lay = dag_layout(plan, geom.par_vec)
    base = _ring_bases(lay.wins)
    F = plan.n_streams
    k = _new_table(tables_of(geom, dag), big)
    _stage_tables(k, [(st, bc) for st, bc, _ in dag.stages], geom.ndim,
                  coeffs_packed)
    # unroll_dag's order: per iteration the stages in topological order,
    # then one state node per updated field
    n_state = sum(u != ~f for f, u in enumerate(dag.updates))
    stage_of = (list(dag.topo) + [-1] * n_state) * geom.par_time
    field_of = {o: f for f, o in enumerate(plan.outputs)}
    Stream = _build.BigStream if big else _build.Stream
    for f in range(F):
        k.f[f] = Stream(base.get(f, 0), lay.wins[f],
                        int(field_of.get(f) == f), 0)
    _fill_entries(k, [(lay.lags[F + i], stage_of[i], e.iteration,
                       field_of.get(F + i, -1), base.get(F + i, 0),
                       lay.wins[F + i], [(base[p], lay.wins[p])
                                         for p in e.inputs])
                      for i, e in enumerate(plan.entries)], big)
    return k, lay.out_lag, len(plan.entries)


# --- the DAG bodies' one-barrier form ----------------------------------------

#: own-cell values a thread of the one-barrier DAG body keeps in registers
#: at once (``stencil_stream.cu``'s ``kCarries``)
CARRIES = 4
#: static shared memory of the one-barrier DAG body: per entry its record,
#: two tick records (built a tick ahead) and its place in the list of the
#: entries that compute, the taps (also as ``TapX``, with their offset in
#: the plane and coefficient) and the coefficients (``stencil_stream.cu``'s
#: ``WinRec``, ``WinTick``, ``TapX``)
WINREC_BYTES, WINTICK_BYTES, TAPX_BYTES = 144, 32, 16
WIN_TABLE_SMEM = -(-((WINREC_BYTES + 2 * WINTICK_BYTES + 4) * MAX_ENTRIES
                      + 4 + (4 + TAPX_BYTES) * MAX_TAPS + 4 * MAX_COEFFS)
                   // 16) * 16


def entry_taps(e) -> tuple:
    """Per input of the unrolled entry ``e`` (a ``programs.DagNode``), the
    sorted ``(|ds|, cross)`` pairs of the taps the kernel reads: ``ds`` the
    stream-axis offset (its sign dropped: reflect mirrors a tap to the
    other side), ``cross`` whether the tap leaves the cell's own column.  A
    Table-2 stencil and a tap table read their offsets, a combine and a
    state node each input's centre, a custom ``apply`` its traced taps."""
    st = e.stencil
    if st is None:
        return (((0, False),),) * len(e.inputs)
    if stage_op(st) == CUSTOM_OP:
        per = [set() for _ in e.inputs]
        for node in codegen.trace(st).nodes:
            if node.op == "tap":
                per[node.attr[0]].add(node.attr[1])
    elif st.combine:
        per = [{(0,) * st.ndim} for _ in e.inputs]
    else:
        per = [set(st.offsets)]
    return tuple(tuple(sorted({(abs(o[0]), any(o[1:])) for o in offs}))
                 for offs in per)


def resolved(plan, v: int) -> frozenset:
    """The values a read of value ``v`` of ``plan`` may take: ``v`` itself,
    or for a state node (which selects its new or its previous value by
    ``steps``) those of both its inputs, down to stage values and field
    streams."""
    F = plan.n_streams
    if v < F or plan.entries[v - F].stencil is not None:
        return frozenset((v,))
    a, b = plan.entries[v - F].inputs
    return resolved(plan, a) | resolved(plan, b)


class WinLayout(NamedTuple):
    """The one-barrier DAG body's layout of an unrolled DAG at ``par_vec =
    1``: per value id its lag behind the input streams and its ring's
    slots (0: none) in rows, and its register carry (-1: none); the
    output lag.  A state node has no ring: its readers read the value it
    selects (:func:`resolved`)."""
    lags: tuple
    wins: tuple
    regs: tuple
    out_lag: int

    @property
    def slots(self) -> int:
        return sum(self.wins)


def _new_value(plan, v: int) -> int:
    """The value a stage that computes reads for value ``v``: a state node
    of an earlier iteration selects its new value (input 0), since the
    stage's own iteration, and so the state node's, is below ``steps``."""
    F = plan.n_streams
    while v >= F and plan.entries[v - F].stencil is None:
        v = plan.entries[v - F].inputs[0]
    return v


def _consumers(plan) -> dict:
    """Value id -> ``(entry, input, declared input)`` of every read of it:
    the stages' inputs (:func:`_new_value`), and the state nodes whose
    value drains to an output field (the others only alias), which by
    ``steps`` may take any value they select (:func:`resolved`)."""
    F = plan.n_streams
    drains = {o for o in plan.outputs if o >= F}
    reads: dict = {}
    for i, e in enumerate(plan.entries):
        if e.stencil is None:
            if F + i in drains:
                for q in resolved(plan, F + i):
                    reads.setdefault(q, []).append((i, 0, F + i))
            continue
        for z, p in enumerate(e.inputs):
            reads.setdefault(_new_value(plan, p), []).append((i, z, p))
    return reads


@functools.lru_cache(maxsize=256)
def win_layout(dag: DagSpec, par_time: int, mixed: bool) -> WinLayout:
    """:class:`WinLayout` of ``dag`` unrolled ``par_time`` times.  The
    body runs one barrier a tick, so a thread reads another thread's value
    only from a row written at an earlier tick: entry ``i`` computes row
    ``t - lag_i`` at tick ``t``, and reads input ``p``'s row ``j + ds``
    (written at tick ``j + ds + lag_p``), so ``lag_i >= lag_p + |ds|`` for
    a tap in its own column and ``lag_p + |ds| + 1`` for a tap in another
    (``programs.dag_layout`` adds only the radius).  A ring holds a value
    from its oldest row read to the row written this tick: ``lag_i + R -
    lag_p + 1`` rows for a reader of radius ``R``.  A stage value whose
    every reader is a combine at its own lag (it reads the value in its
    own cell at the tick it is made) and which no state node selects
    stays in a register carry (at most :data:`CARRIES` at once); in the
    mixed-boundary body (``mixed``) it also keeps a ring, which the
    grid-edge CTAs, re-imposing at read time, read behind a barrier an
    entry."""
    plan = unroll_dag(dag, par_time)
    F = plan.n_streams
    n = len(plan.entries)
    taps = [entry_taps(e) for e in plan.entries]
    lags = [0] * (F + n)
    for i, e in enumerate(plan.entries):
        lags[F + i] = max(
            lags[p] + max((ds + c for ds, c in taps[i][z]), default=0)
            for z, p in enumerate(e.inputs))
    reads = _consumers(plan)
    wins = [0] * (F + n)
    for q, rs in reads.items():
        wins[q] = max(lags[F + i] + max((ds for ds, _ in taps[i][z]),
                                        default=0) - lags[q] + 1
                      for i, z, _ in rs)
    selected = {q for e in plan.entries if e.stencil is None
                for p in e.inputs for q in resolved(plan, p)}
    regs = [-1] * (F + n)
    free_at = [0] * CARRIES            # entry index from which a carry is free
    for i, e in enumerate(plan.entries):
        v = F + i
        rs = reads.get(v, ())
        if (e.stencil is None or not rs or v in selected
                or any(p != v or not plan.entries[c].stencil.combine
                       or lags[F + c] != lags[v] for c, _, p in rs)):
            continue
        last = max(c for c, _, _ in rs)
        slot = next((s for s in range(CARRIES) if free_at[s] <= i), None)
        if slot is None:
            continue
        regs[v] = slot
        free_at[slot] = last + 1
        if not mixed:
            wins[v] = 0
    out_lag = max(lags[o] for o in plan.outputs)
    return WinLayout(tuple(lags), tuple(wins), tuple(regs), out_lag)


def _mirrors_inside(lo: int, hi: int, n: int) -> bool:
    """``stencil_stream.cu``'s ``mirrors_inside``: whether reflect maps
    every cell of a block's axis outside the grid (edges ``lo``, ``hi`` in
    block coordinates, ``n`` cells) onto a cell inside it."""
    above = hi >= n - 1 or 2 * hi - (n - 1) >= max(lo, 0)
    below = lo <= 0 or 2 * lo <= min(hi, n - 1)
    return above and below


def own_columns(geom: BlockGeometry, bc) -> bool:
    """Whether every block of ``geom`` holds, in each cell outside the
    grid, what the cell ``bc``'s blocked-axis kinds map it to holds
    (``stencil_stream.cu``'s ``own_columns`` on every CTA): always but
    under reflect, where a grid that ends well inside a block's overhang
    mirrors some cells onto others outside it."""
    kinds = boundary.kinds_of(bc, geom.ndim)[1:]
    h = geom.size_halo
    return all(
        _mirrors_inside(h - b * c, d - 1 + h - b * c, n)
        for k, c, d, n, nb in zip(kinds, geom.csize, geom.blocked_dims,
                                  geom.bsize, geom.bnum)
        if k == "reflect" for b in range(nb))


def win_smem(dag: DagSpec, geom: BlockGeometry, cell_bytes: int = 4) -> int:
    """Dynamic shared memory of a one-barrier form: a chain's
    (:func:`chain_smem` at :func:`chain_look`), or the DAG body's rings
    (:func:`win_layout`), with ``rad * (bx + 1)`` cells before the first
    and after the last (``rad`` cells in a 2D block row) that a
    blocked-axis tap of the largest stage radius ``rad``, read without
    clipping to the block, may reach (``stencil_stream.cu``'s
    ``win_pad``)."""
    stages = _as_chain(dag)
    if stages is not None:
        return chain_smem(stages, geom, cell_bytes,
                          chain_look(stages, geom, cell_bytes))
    lay = win_layout(dag, geom.par_time, mixes_boundaries(dag, geom.ndim))
    by, bx = _plane_rows(geom)
    rad = max(st.radius for st, _, _ in dag.stages)
    pad = rad * (bx + 1 if by > 1 else 1)
    return (lay.slots * by * bx + 2 * pad) * cell_bytes


def win_form(dag: DagSpec, geom: BlockGeometry,
             cell_bytes: int = 4) -> Optional[str]:
    """None when the kernel runs ``dag`` at ``geom`` in a one-barrier form
    (a chain in the chain body's, :func:`chain_form`; any other DAG in the
    DAG bodies', ``dag_kernel``), else why its launch takes a form with a
    barrier after every entry: ``par_vec > 1``, a plane over 1024 cells,
    the large-table route, a single-boundary DAG whose reflect mirrors a
    block's overhang past the grid (its state nodes copy re-imposed
    values, which aliases would not), or the deeper rings of
    :func:`win_layout` past shared memory or the table's 16-bit fields."""
    stages = _as_chain(dag)
    if stages is not None:
        return chain_form(stages, geom, cell_bytes)
    if geom.par_vec != 1:
        return "par_vec > 1"
    if math.prod(geom.bsize) > MAX_THREADS:
        return "a plane over 1024 cells"
    if tables_of(geom, dag).big:
        return "the large-table route"
    mixed = mixes_boundaries(dag, geom.ndim)
    if not mixed and not own_columns(geom, dag.stages[0][1]):
        return "reflect maps a block's overhang past the grid"
    lay = win_layout(dag, geom.par_time, mixed)
    if max(max(lay.wins), max(lay.lags)) > SHORT_MAX:
        return "lags or rings past the table's 16-bit fields"
    smem = win_smem(dag, geom, cell_bytes) + WIN_TABLE_SMEM
    if smem > SMEM_LIMIT:
        return (f"its rings and tables need {smem} bytes of shared memory "
                f"(at most {SMEM_LIMIT})")
    return None


def _win_table(dag: DagSpec, geom: BlockGeometry, coeffs_packed):
    """The kernel's ``Program`` table for the one-barrier DAG body: as
    :func:`_dag_table` with :func:`win_layout`'s lags and rings, each
    entry's register carry in ``Entry.pad`` (-1: none), and its inputs as
    value ids in ``in_base`` (``in_slots`` 0), which the kernel resolves
    through the state nodes by ``steps``.  Returns ``(table, out_lag,
    n_entries, ring slots)``."""
    plan = unroll_dag(dag, geom.par_time)
    lay = win_layout(dag, geom.par_time, mixes_boundaries(dag, geom.ndim))
    base = _ring_bases(lay.wins)
    F = plan.n_streams
    k = _build.Program()
    _stage_tables(k, [(st, bc) for st, bc, _ in dag.stages], geom.ndim,
                  coeffs_packed)
    n_state = sum(u != ~f for f, u in enumerate(dag.updates))
    stage_of = (list(dag.topo) + [-1] * n_state) * geom.par_time
    field_of = {o: f for f, o in enumerate(plan.outputs)}
    for f in range(F):
        k.f[f] = _build.Stream(base.get(f, 0), lay.wins[f],
                               int(field_of.get(f) == f), 0)
    for i, e in enumerate(plan.entries):
        ins = list(e.inputs) + [0] * (MAX_INPUTS - len(e.inputs))
        k.e[i] = _build.Entry(lay.lags[F + i], stage_of[i], e.iteration,
                              field_of.get(F + i, -1), base.get(F + i, 0),
                              lay.wins[F + i], len(e.inputs), lay.regs[F + i],
                              tuple(ins), (0,) * MAX_INPUTS)
    return k, lay.out_lag, len(plan.entries), lay.slots


# --- the chain body's one-barrier form ---------------------------------------

#: static shared memory of the chain body's one-barrier form: per entry its
#: record and two tick records (built a tick ahead), the taps (with their
#: offset in the plane and coefficient) and the coefficients
#: (``stencil_stream.cu``'s ``ChainWinRec``, ``ChainTick``, ``ChainTap``)
CHAINREC_BYTES, CHAINTICK_BYTES, CHAINTAP_BYTES = 80, 32, 16
CHAIN_TABLE_SMEM = ((CHAINREC_BYTES + 2 * CHAINTICK_BYTES) * MAX_ENTRIES
                    + CHAINTAP_BYTES * MAX_TAPS + 4 * MAX_COEFFS)
#: its static part as ``ptxas`` counts it: the records, tick records and
#: taps (11264 bytes for ``chain_win_kernel<0,*>`` in the sweep of
#: ``tests/torch_calibration_h100.json``, NVIDIA H100 80GB HBM3)
CHAIN_WIN_STATIC = ((CHAINREC_BYTES + 2 * CHAINTICK_BYTES) * MAX_ENTRIES
                    + CHAINTAP_BYTES * MAX_TAPS)
#: the entries the chain body's one-barrier form unrolls (its ``kT``): the
#: least of these that holds the chain; a longer chain runs its ring form
#: (``kT`` 0)
CHAIN_UNROLLS = (4, 8)


@functools.lru_cache(maxsize=256)
def chain_layout(stages: tuple, par_time: int) -> WinLayout:
    """:func:`win_layout` of the chain ``((stencil, bc), ...)`` as a path
    graph (``programs.chain_dag``): entry ``i`` lags its producer by the
    stage's reach, ``|ds|`` rows for a tap in its own column and ``|ds| +
    1`` for one in another, and each ring holds its value from the oldest
    row its consumer reads to the row written this tick.  A chain has no
    combine, so no value stays in a register carry."""
    return win_layout(chain_dag(stages), par_time, False)


def chain_steps(stages) -> tuple:
    """Per stage ``(step, register)``: the rows its entries lag their
    producer (the stage's reach, :func:`chain_layout`), and whether every
    tap in its own column reads a row at most 2 behind the producer's
    newest (``step - ds`` in 0..2: a Table-2 stencil, a star of radius 0
    or 1, a custom ``apply`` that reaches no further), which the
    register form keeps in registers at the thread's cell."""
    out = []
    plan = unroll_dag(chain_dag(stages), 1)
    for e in plan.entries:
        (taps,) = entry_taps(e)
        step = max((ds + c for ds, c in taps), default=0)
        own = max((ds for ds, c in taps if not c), default=0)
        out.append((step, step + own <= 2))
    return tuple(out)


def chain_unroll(n_entries: int) -> int:
    """The ``kT`` of :data:`CHAIN_UNROLLS` that runs ``n_entries``, or 0
    for the ring form."""
    return next((kt for kt in CHAIN_UNROLLS if n_entries <= kt), 0)


def chain_pad(geom: BlockGeometry, rad: int, cell_bytes: int = 4) -> int:
    """Cells before the chain form's first ring and after its last that a
    blocked-axis tap of radius ``rad``, read without clipping to the
    block, may reach (``stencil_stream.cu``'s ``chain_pad``): ``rad`` rows
    and cells of the staged stream, and two cells more for the bfloat16
    row shift, rounded up to an even count (the stream's slots stay
    4-byte aligned)."""
    by, srow = _stream_rows(geom, cell_bytes)
    return (rad * (srow + 1 if by > 1 else 1) + 3) & ~1


def chain_smem(stages, geom: BlockGeometry, cell_bytes: int = 4,
               look: int = 1) -> int:
    """Dynamic shared memory of the chain body's one-barrier form copying
    ``look`` slabs of the field stream ahead: the stream's ring of
    :func:`chain_layout`'s rows and ``look`` more, staged, then the
    entries' rings of block planes, with :func:`chain_pad` cells before
    and after."""
    lay = chain_layout(tuple(stages), geom.par_time)
    by, srow = _stream_rows(geom, cell_bytes)
    rad = max(st.radius for st, _ in stages)
    cells = ((lay.wins[0] + look) * by * srow
             + sum(lay.wins[1:]) * math.prod(geom.bsize))
    return (cells + 2 * chain_pad(geom, rad, cell_bytes)) * cell_bytes


def chain_look(stages, geom: BlockGeometry, cell_bytes: int = 4) -> int:
    """The slabs of the field stream the chain form copies ahead: up to
    :data:`MAX_LOOK`, fewer where shared memory is short, 0 when not even
    one fits."""
    for look in range(MAX_LOOK, 0, -1):
        if (chain_smem(stages, geom, cell_bytes, look) + CHAIN_TABLE_SMEM
                <= SMEM_LIMIT):
            return look
    return 0


def _kinds_follow(stages, ndim: int, par_time: int) -> bool:
    """Whether every entry of the chain but the last may read its own
    column: the value it reads took, at push time, its own stage's
    blocked-axis kinds (the field stream, stage 0's), and the position it
    computes at is its consumer's, so the two must map each cell alike on
    every axis, unless the consumer's kind there is constant (it then
    computes at the cell itself and writes the fill where it is outside
    the grid)."""
    kinds = [boundary.kinds_of(bc, ndim)[1:] for _, bc in stages]
    S = len(stages)
    for i in range(S * par_time - 1):
        mine, cons = kinds[i % S], kinds[(i + 1) % S]
        if any(c != m and c != "constant" for c, m in zip(cons, mine)):
            return False
    return True


def chain_form(stages, geom: BlockGeometry,
               cell_bytes: int = 4) -> Optional[str]:
    """None when the kernel runs the chain ``((stencil, bc), ...)`` at
    ``geom`` in the chain body's one-barrier form (``chain_win_kernel``),
    else why its launch takes ``chain_kernel`` or ``chain_kernel_big``,
    with a barrier after every entry: the main-path body (one Table-2
    stage), ``par_vec > 1``, a one-cell plane (a 1D grid: a CTA of one
    working thread, where the per-entry form ran the chip's 1D star
    faster), a plane over 1024 cells, the large-table route, a stage whose
    reflect mirrors a block's overhang past the grid, a bfloat16 stream
    whose rows do not all start on one half of a 4-byte word
    (:func:`whole_word_rows`), a stage whose blocked-axis kinds its
    consumer does not share (:func:`_kinds_follow`: a thread could not
    read its own column), or the deeper rings past the table's 16-bit
    fields or shared memory."""
    stages = tuple(stages)
    if is_main_path(stages):
        return "the main-path body"
    if geom.par_vec != 1:
        return "par_vec > 1"
    if math.prod(geom.bsize) == 1:
        return "a one-cell block plane (1D)"
    if math.prod(geom.bsize) > MAX_THREADS:
        return "a plane over 1024 cells"
    if tables_of(geom, stages).big:
        return "the large-table route"
    if not all(own_columns(geom, bc) for _, bc in stages):
        return "reflect maps a block's overhang past the grid"
    if not whole_word_rows(geom, cell_bytes):
        return ("a bfloat16 stream whose rows lie an odd count of cells "
                "apart (its copies ahead are 4-byte words)")
    if not _kinds_follow(stages, geom.ndim, geom.par_time):
        return "a stage's consumer re-imposes under other blocked-axis kinds"
    lay = chain_layout(stages, geom.par_time)
    if max(max(lay.wins) + MAX_LOOK, max(lay.lags)) > SHORT_MAX:
        return "lags or rings past the table's 16-bit fields"
    if not chain_look(stages, geom, cell_bytes):
        smem = chain_smem(stages, geom, cell_bytes) + CHAIN_TABLE_SMEM
        return (f"its rings and tables need {smem} bytes of shared memory "
                f"(at most {SMEM_LIMIT})")
    return None


def star_radius(stencil: Stencil, ndim: int) -> int:
    """0 or 1 for a tap table whose taps are ``make_star(ndim, 0)``'s or
    ``make_star(ndim, 1)``'s in their order (each tap its own coefficient),
    which the chain body's one-barrier form computes without reading its
    taps; -1 for any other stencil."""
    taps = linear_taps(stencil)
    for r in (0, 1):
        if taps == tuple(enumerate(make_star(ndim, r).offsets)):
            return r
    return -1


def _chain_table(stages, geom: BlockGeometry, coeffs_packed, look: int):
    """The kernel's ``Program`` table for the chain body's one-barrier
    form: per entry :func:`chain_layout`'s lag and ring (out_base,
    out_slots; the last entry none), its producer's ring (in_base[0],
    in_slots[0]) and in ``pad`` 1 where its stage's own-column taps read
    the register window (:func:`chain_steps`); per stage in ``pad`` 1 or
    2 for a star of radius 0 or 1 (:func:`star_radius`); the field
    stream's ring,
    ``look`` slots deeper than the layout's, in ``f[0]``; rings laid out
    in value-id order.  Returns ``(table, out_lag)``."""
    lay = chain_layout(tuple(stages), geom.par_time)
    wins = (lay.wins[0] + look,) + lay.wins[1:]
    base = _ring_bases(wins)
    steps = chain_steps(stages)
    S = len(stages)
    k = _build.Program()
    _stage_tables(k, stages, geom.ndim, coeffs_packed)
    for s, (st, _) in enumerate(stages):
        k.s[s].pad = star_radius(st, geom.ndim) + 1
    k.f[0] = _build.Stream(0, wins[0], 0, 0)
    for i in range(S * geom.par_time):
        k.e[i] = _build.Entry(lay.lags[1 + i], i % S, i // S, -1,
                              base.get(1 + i, 0), wins[1 + i], 1,
                              int(steps[i % S][1]),
                              (base[i], 0, 0, 0), (wins[i], 0, 0, 0))
    return k, lay.out_lag


#: the stream split: the waves of CTAs it aims to fill the card with, and
#: the largest share of a segment's slabs its warm-up may add
SPLIT_WAVES, WARM_SHARE = 2, 0.05
#: the cap of the kernel grid's y axis, which carries block rows times
#: segments (the batch members run along z)
MAX_GRID_Y = 65535


def stream_warmup(dag: DagSpec, geom: BlockGeometry) -> int:
    """Slabs a segment of the chain or main-path body streams before its
    own: the program's critical-path radius times ``par_time`` in rows —
    as far down the stream as a wrong value at the first row streamed
    travels through the unrolled entries — rounded up to slabs."""
    return -(-dag_radius(dag) * geom.par_time // geom.par_vec)


def segment_plan(nslabs: int, warm: int, ctas: int, per_sm: int, n_sm: int,
                 nby: int = 1, lag: int = 0) -> tuple:
    """``(seg, nseg)``: the stream's ``nslabs`` slabs cut into ``nseg``
    segments of ``seg`` slabs (the last one may be shorter), each streamed
    by its own CTA of every block, ``ctas`` CTAs a segment (blocks times
    batch members).  At least as many segments as fill ``n_sm`` SMs
    holding ``per_sm`` CTAs each for :data:`SPLIT_WAVES` waves, and no more
    than keep the warm-up of ``warm`` slabs within :data:`WARM_SHARE` of a
    segment, nor than the grid's y axis holds beside ``nby`` block rows;
    among those (up to four times the fewest), the count whose waves of
    CTAs times the ticks of one CTA (``seg + warm + lag``, ``lag`` the
    output lag) is least, the fewest segments on a tie: a last wave that
    is nearly empty costs a whole one."""
    slots = max(per_sm, 1) * n_sm
    want = max(1, -(-SPLIT_WAVES * slots // ctas))
    cap = int(nslabs * WARM_SHARE) // warm if warm else nslabs
    cap = max(1, min(cap, MAX_GRID_Y // nby, nslabs))
    best = None
    for nseg in range(min(want, cap), min(4 * want, cap) + 1):
        seg = -(-nslabs // nseg)
        nseg = -(-nslabs // seg)
        cost = -(-nseg * ctas // slots) * (seg + warm + lag)
        if best is None or cost < best[0]:
            best = (cost, seg, nseg)
    return best[1], best[2]


class StreamSplit(NamedTuple):
    """How one launch streams: ``nseg`` segments of ``seg`` of the
    stream's ``nslabs`` slabs, each streaming ``warm`` slabs before its
    own (fewer near the stream's start), ``look`` slabs copied ahead (the
    main path's register form; 0 otherwise), ``per_sm`` CTAs an SM holds
    (the kernel's occupancy), ``ctas`` CTAs of ``threads`` threads and
    ``smem`` bytes of shared memory a launch, the CTA barriers a tick (the
    main path's blocks whose reflect mirrors leave the grid, and the
    mixed-boundary DAG body's grid-edge blocks, take one per entry
    besides), the body, the kernel that runs it as
    ``_build.ptxas_report(lib, all_args=True)`` names it in ``library``,
    the barrier form and why (``form``), and the bytes of its rings."""
    seg: int
    nseg: int
    warm: int
    look: int
    per_sm: int
    ctas: int
    threads: int
    smem: int
    barriers: int
    nslabs: int
    body: int
    kernel: str
    library: str
    form: str
    ring_bytes: int

    @property
    def warm_share(self) -> float:
        """The slabs streamed before the segments' own, per slab of the
        stream."""
        return sum(min(self.warm, k * self.seg)
                   for k in range(self.nseg)) / self.nslabs


#: the split of the last launch (diagnostics: chip_smoke.py prints it)
LAST_SPLIT: Optional[StreamSplit] = None
_SPLITS: dict = {}
_SPLITS_LOCK = threading.Lock()


class _LaunchPlan(NamedTuple):
    """What every launch of one program at one geometry shares: the body
    that runs it, its table (a ``Program`` passed by value, or the
    large-table route's table in a device buffer), the output lag, the
    entries and field streams, the first stage's BC, whether some stage
    has a reflect or constant axis (the kernels that do the boundary
    work), the records' shared memory in front of the rings, and the
    large-table route's table lengths ``(stages, taps, coefficients,
    inputs)`` (None for the parameter table), whether the program runs a
    one-barrier form (:func:`win_form`), its layout's ring slots, the
    largest radius of a stage, and the slabs of the field stream the
    chain body's one-barrier form copies ahead (:func:`chain_look`) and
    the entries it unrolls (:func:`launch_form`)."""
    body: int
    table: object
    out_lag: int
    n_entries: int
    n_fields: int
    bc0: object
    bcs: bool
    table_smem: int
    big: Optional[tuple]
    win: bool
    slots: int
    rad: int
    look: int = 0
    unroll: int = 0


@functools.lru_cache(maxsize=256)
def launch_form(dag: DagSpec, geom: BlockGeometry,
                cell_bytes: int = 4) -> tuple:
    """``(win, unroll)`` of every launch of ``dag`` at ``geom`` in storage
    of ``cell_bytes`` a cell: whether it runs a one-barrier form
    (:func:`win_form`), and the entries the chain body's one-barrier form
    unrolls there (:func:`chain_unroll`; 0 for its ring form and every
    other form)."""
    win = win_form(dag, geom, cell_bytes) is None
    stages = _as_chain(dag)
    if not win or stages is None:
        return win, 0
    return win, chain_unroll(len(stages) * geom.par_time)


def _body(dag: DagSpec, ndim: int) -> int:
    """The kernel body that runs ``dag``: a path graph's chain (or
    main-path) body, else the DAG body, or the mixed-boundary one when its
    stages differ in boundary."""
    stages = _as_chain(dag)
    if stages is not None:
        return kernel_body(stages)
    return MIX_BODY if mixes_boundaries(dag, ndim) else DAG_BODY


def _has_bcs(dag: DagSpec, ndim: int) -> bool:
    """Whether some stage has a reflect or constant axis (the kernels that
    do the boundary work)."""
    return any(k in ("reflect", "constant") for _, bc, _ in dag.stages
               for k in boundary.kinds_of(bc, ndim))


#: ``stencil_stream.cu``'s form id of the one-barrier forms of the chain
#: and DAG bodies (``kWinForm``; the table-driven bodies' ``Form``s are 0
#: to 3)
WIN_FORM = 4


def _form(geom: BlockGeometry, tab: Tables, win: bool = False) -> int:
    """``stencil_stream.cu``'s ``Form`` of a table-driven body at ``geom``:
    its V = 1, one-row, several-row or wide form (:func:`cta_shape`), or
    :data:`WIN_FORM` for a one-barrier form (``win``)."""
    if win:
        return WIN_FORM
    _, rows, _ = cta_shape(geom, tab)
    if tab.big or math.prod(geom.bsize) > MAX_THREADS:
        return 3
    return 0 if geom.par_vec == 1 else 1 if rows == 1 else 2


@functools.lru_cache(maxsize=64)
def _custom_build(dag: DagSpec, geom: BlockGeometry, bf16: bool,
                  batch: bool) -> Optional[tuple]:
    """``(generated header, nvcc flags)`` of the library that launches
    ``dag`` at ``geom``: its custom stencils' device functions and the one
    kernel it takes; None when no stage is custom (the shared libraries
    run it)."""
    customs = custom_stencils([(st, bc) for st, bc, _ in dag.stages])
    if not customs:
        return None
    tab = tables_of(geom, dag)
    win, kt = launch_form(dag, geom, 2 if bf16 else 4)
    return (codegen.program_header([codegen.trace(st) for st in customs]),
            _build.custom_flags(bf16, batch, _body(dag, geom.ndim),
                                _form(geom, tab, win),
                                _has_bcs(dag, geom.ndim), tab.big, kt))


def custom_library(dag: DagSpec, geom: BlockGeometry,
                   dtype: torch.dtype = torch.float32, batch: bool = False):
    """The path of the generated library that launches ``dag`` at ``geom``
    in ``dtype`` (``batch``: for batches of two or more), built unless it
    exists, as its first launch would; None when no stage is custom."""
    key = _custom_build(dag, geom, dtype == torch.bfloat16, batch)
    return None if key is None else _build.build_custom(*key)


@functools.lru_cache(maxsize=64)
def _prepared(dag: DagSpec, geom: BlockGeometry, coeffs: tuple,
              device: torch.device, cell_bytes: int = 4) -> _LaunchPlan:
    """:class:`_LaunchPlan` of ``dag`` at ``geom`` with the packed
    coefficients ``coeffs`` in storage of ``cell_bytes`` a cell, in the
    form :func:`launch_form` picks, built once and kept for the program's
    later super-steps: the large-table route copies its table to
    ``device`` here, not at every launch."""
    shape = launch_shape(dag, geom, cell_bytes)
    coeffs_packed = torch.tensor(coeffs, dtype=torch.float32)
    stages = _as_chain(dag)
    big = shape.big is not None
    if stages is not None and shape.win:
        table = _chain_table(stages, geom, coeffs_packed, shape.look)[0]
    elif stages is not None:
        table = _program_table(stages, geom, coeffs_packed, big)[0]
    elif shape.win:
        table = _win_table(dag, geom, coeffs_packed)[0]
    else:
        table = _dag_table(dag, geom, coeffs_packed, big)[0]
    if big:
        table = torch.frombuffer(bytearray(table),
                                 dtype=torch.uint8).to(device)
    return shape._replace(table=table)


def _params(prog: _LaunchPlan, geom: BlockGeometry, ns: int,
            steps: int) -> tuple:
    """``(Params, grid_x, nby)`` of a launch of ``prog`` over a stream of
    ``ns`` rows, the split left unset: a 1D grid is a 3D one with one
    blocked cell, a 2D grid one with a single blocked y row."""
    pad, blk, cmp, dims = (geom.padded_dims, geom.bsize, geom.csize,
                           geom.blocked_dims)
    hy = hx = geom.size_halo
    if geom.ndim == 1:
        pad = blk = cmp = dims = (1, 1)
        hy = hx = 0
    elif geom.ndim == 2:
        pad, blk, cmp, dims = ((1,) + pad, (1,) + blk, (1,) + cmp,
                               (1,) + dims)
        hy = 0
    V = geom.par_vec
    bnum = geom.bnum
    nby = bnum[0] if geom.ndim == 3 else 1
    params = _build.Params(
        ns=ns, dom=_stream_dom(geom, prog.bc0), V=V,
        ticks=ns // V + prog.out_lag, py=pad[0], px=pad[1], by=blk[0],
        bx=blk[1], cy=cmp[0], cx=cmp[1], dy=dims[0], dx=dims[1], hy=hy,
        hx=hx, steps=steps, n_entries=prog.n_entries,
        n_fields=prog.n_fields, seg=ns // V, warm=0, nby=nby, look=0,
        win=int(prog.win) + prog.unroll, rad=prog.rad)
    return params, bnum[-1] if bnum else 1, nby


def _kernel_name(prog: _LaunchPlan, geom: BlockGeometry,
                 tab: Optional[Tables], look: int,
                 custom: bool = False) -> str:
    """The kernel ``stencil_stream.cu``'s launcher picks for ``prog`` at
    ``geom`` (``look`` > 0: the main path's register form; ``custom``: a
    library of a program's custom stencils, whose table-driven DAG forms
    are all ``stream_kernel_x``), named as ``_build.ptxas_report(...,
    all_args=True)`` names it: its int and bool template arguments (body,
    ``Form``, boundary work, entries; the chain body's one-barrier form
    by its unrolled entries, ``prog.unroll``)."""
    bcs = int(prog.bcs)
    if prog.body >= 0:
        if look:
            kt = next(k for k in (4, 8, 16) if prog.n_entries <= k)
            return f"main_kernel<{prog.body},0,{bcs},{kt}>"
        form = (3 if math.prod(geom.bsize) > MAX_THREADS
                else 0 if geom.par_vec == 1 else 2)
        return f"main_kernel<{prog.body},{form},{bcs},0>"
    if prog.big is not None:
        return (f"chain_kernel_big<{bcs}>" if prog.body == CHAIN_BODY
                else f"stream_kernel_big<{prog.body},{bcs}>")
    if prog.win and prog.body == CHAIN_BODY:
        return f"chain_win_kernel<{bcs},{prog.unroll}>"
    if prog.win:
        return f"dag_kernel<{prog.body},{bcs}>"
    form = _form(geom, tab)
    if prog.body == CHAIN_BODY:
        return f"chain_kernel<{form},{bcs}>"
    x = "_x" if form == 3 or prog.body == MIX_BODY or custom else ""
    return f"stream_kernel{x}<{prog.body},{form},{bcs}>"


def _edge_blocks(geom: BlockGeometry, bc) -> int:
    """The blocks of ``geom`` that hold a grid edge along a blocked axis
    that is not periodic (where the mixed-boundary DAG body re-imposes)."""
    kinds = boundary.kinds_of(bc, geom.ndim)[1:]
    h = geom.size_halo
    edge = [[k != "periodic" and (h - b * c > 0 or d - 1 + h - b * c < n - 1)
             for b in range(nb)]
            for k, c, d, n, nb in zip(kinds, geom.csize, geom.blocked_dims,
                                      geom.bsize, geom.bnum)]
    if not edge:
        return 0
    inner = math.prod(sum(not e for e in ax) for ax in edge)
    return math.prod(geom.bnum) - inner


def _barrier_form(dag: DagSpec, prog: _LaunchPlan,
                  geom: BlockGeometry, cell_bytes: int) -> tuple:
    """``(barriers a tick, form)`` of a launch: one for the main-path
    body and the one-barrier forms of the chain and DAG bodies (the
    mixed-boundary body's grid-edge blocks one per entry besides), else
    one per entry and one for the push, and why (:func:`win_form`)."""
    if prog.body >= 0:
        return 1, "one barrier a tick"
    if prog.win:
        form = "one barrier a tick"
        edges = (_edge_blocks(geom, prog.bc0) if prog.body == MIX_BODY
                 else 0)
        if edges:
            form += (f"; {edges} of {math.prod(geom.bnum)} blocks hold a "
                     f"grid edge and re-impose at read time, one barrier an "
                     f"entry")
        return 1, form
    return (prog.n_entries + 1,
            f"one barrier an entry: {win_form(dag, geom, cell_bytes)}")


def _split_of(dag: DagSpec, prog: _LaunchPlan, geom: BlockGeometry,
              nslabs: int, nby: int, grid_x: int, batch: int, per_sm: int,
              n_sm: int, smem: int, cell_bytes: int,
              segments: Optional[int] = None, custom: bool = False,
              library: str = "") -> StreamSplit:
    """:class:`StreamSplit` of a launch of ``prog`` over ``nslabs`` slabs
    whose kernel an SM holds ``per_sm`` CTAs of, on a card of ``n_sm``
    SMs: :func:`segment_plan`'s cut (or about ``segments`` segments)."""
    tab = tables_of(geom, dag)
    _, _, threads = cta_shape(geom, tab)
    look = main_look(geom, cell_bytes) if prog.body >= 0 else prog.look
    warm = stream_warmup(dag, geom)
    ctas = grid_x * nby * batch
    seg, nseg = segment_plan(nslabs, warm, ctas, per_sm, n_sm, nby,
                             prog.out_lag)
    if segments is not None:
        seg = -(-nslabs // min(max(segments, 1), nslabs))
        nseg = -(-nslabs // seg)
    barriers, form = _barrier_form(dag, prog, geom, cell_bytes)
    return StreamSplit(seg, nseg, warm, look, per_sm, ctas * nseg, threads,
                       smem, barriers, nslabs, prog.body,
                       _kernel_name(prog, geom, tab, look, custom), library,
                       form, smem - prog.table_smem)


def _split(dll, dag: DagSpec, prog: _LaunchPlan, geom: BlockGeometry,
           params, grid_x: int, batch: int, member_stride: int,
           aux_stride: int, smem: int, cell_bytes: int, device,
           segments: Optional[int] = None,
           custom: bool = False) -> StreamSplit:
    """:class:`StreamSplit` of a launch (kept per library, program shape,
    batch and device): every body by :func:`segment_plan` over the
    kernel's occupancy (``stencil_stream_occupancy``) and the card's SMs
    (or in about ``segments`` segments); ``custom``: from a library of
    custom stencils."""
    key = (id(dll), prog.body, prog.bcs, prog.big is not None, prog.win,
           tuple(getattr(params, f) for f, _ in params._fields_ if
                 f != "steps"), grid_x, batch, member_stride > 0,
           aux_stride > 0, smem, cell_bytes, str(device), segments)
    with _SPLITS_LOCK:
        hit = _SPLITS.get(key)
    if hit is not None:
        return hit
    probe = _build.Params.from_buffer_copy(params)
    probe.look = main_look(geom, cell_bytes) if prog.body >= 0 else prog.look
    per_sm = dll.stencil_stream_occupancy(
        prog.body, int(prog.bcs), probe, int(prog.big is not None),
        batch, member_stride, aux_stride, smem)
    if per_sm < 0:
        raise RuntimeError("stencil_stream: no occupancy for the launch")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    split = _split_of(dag, prog, geom, params.ns // params.V, params.nby,
                      grid_x, batch, per_sm, n_sm, smem, cell_bytes,
                      segments, custom, dll._name)
    with _SPLITS_LOCK:
        _SPLITS[key] = split
    return split


def launch_smem(dag: DagSpec, geom: BlockGeometry,
                cell_bytes: int = 4) -> int:
    """The dynamic shared memory of a launch of ``dag`` at ``geom``: a
    one-barrier form's (:func:`win_smem`), else the rings
    (``core/blocking.smem_bytes``) and, in the large-table route, the
    records in front of them."""
    if launch_form(dag, geom, cell_bytes)[0]:
        return win_smem(dag, geom, cell_bytes)
    tab = tables_of(geom, dag)
    return smem_bytes(geom, dag, cell_bytes) + (
        tab.smem if tab is not None and tab.big else 0)


def static_smem(dag: DagSpec, geom: BlockGeometry,
                cell_bytes: int = 4) -> int:
    """The static shared memory of the kernel that runs ``dag`` at
    ``geom``: the tables a table-driven body keeps as ``__shared__``
    arrays sized to the caps (the one-barrier forms' records and tick
    records, the per-entry forms' :data:`_build.TABLE_SMEM`), none for the
    main-path body or the large-table route (its records are dynamic)."""
    tab = tables_of(geom, dag)
    if tab is None or tab.big:
        return 0
    if launch_form(dag, geom, cell_bytes)[0]:
        return CHAIN_WIN_STATIC if tab.body == "chain" else WIN_TABLE_SMEM
    return TABLE_SMEM[tab.body]


@functools.lru_cache(maxsize=1024)
def launch_shape(dag: DagSpec, geom: BlockGeometry,
                 cell_bytes: int = 4) -> _LaunchPlan:
    """:class:`_LaunchPlan` of ``dag`` at ``geom`` without its table
    (``table`` None), in the form :func:`launch_form` picks: the body,
    output lag, entries, the slabs copied ahead; what :func:`_prepared`
    adds the table to, and what the performance model prices."""
    win, unroll = launch_form(dag, geom, cell_bytes)
    stages = _as_chain(dag)
    tab = tables_of(geom, dag)
    big = tab is not None and tab.big
    look = slots = 0
    if stages is not None and win:
        look = chain_look(stages, geom, cell_bytes)
        lay = chain_layout(stages, geom.par_time)
    elif win:
        lay = win_layout(dag, geom.par_time,
                         mixes_boundaries(dag, geom.ndim))
        slots = lay.slots
    else:
        lay = dag_layout(unroll_dag(dag, geom.par_time), geom.par_vec)
    n_entries = (len(stages) * geom.par_time if stages is not None
                 else len(unroll_dag(dag, geom.par_time).entries))
    return _LaunchPlan(_body(dag, geom.ndim), None, lay.out_lag, n_entries,
                       dag.n_fields, dag.stages[0][1],
                       _has_bcs(dag, geom.ndim), tab.smem if big else 0,
                       (tab.stages, tab.taps, tab.coeffs, tab.all_inputs)
                       if big else None, win, slots,
                       max(st.radius for st, _, _ in dag.stages), look,
                       unroll)


def model_split(dag: DagSpec, geom: BlockGeometry, cell_bytes: int,
                per_sm: int, n_sm: int, batch: int = 1) -> StreamSplit:
    """The :class:`StreamSplit` a launch of ``dag`` at ``geom`` (``batch``
    members) takes on a card of ``n_sm`` SMs holding ``per_sm`` of its
    CTAs each, from :func:`launch_shape` alone: the split the launcher
    would pick, with no library loaded (a custom DAG's per-entry kernel
    named as the shared library's)."""
    prog = launch_shape(dag, geom, cell_bytes)
    nby = geom.bnum[0] if geom.ndim == 3 else 1
    grid_x = geom.bnum[-1] if geom.bnum else 1
    nslabs = geom.stream_slabs(_stream_dom(geom, prog.bc0))
    return _split_of(dag, prog, geom, nslabs, nby, grid_x, batch, per_sm,
                     n_sm, launch_smem(dag, geom, cell_bytes), cell_bytes)


def _launch(dag: DagSpec, prog: _LaunchPlan, geom: BlockGeometry, gp,
            aux_p, out, steps: int, smem: int, batch: Optional[int],
            segments: Optional[int] = None) -> None:
    """Launch one super-step of ``prog`` (``dag``'s) on every member of
    ``gp``, from the shared library of its storage type or, for a program
    with custom stencils, its own (built at the first launch);
    ``batch``: the members along the grid's z axis (None: one).  Member
    ``b`` lies ``b * member_stride`` cells into ``gp`` and ``out``, its
    aux ``b * aux_stride`` cells into ``aux_p`` (0 for a shared aux
    grid).  The grid's y axis carries the block rows times the stream's
    segments (:class:`StreamSplit`; about ``segments`` of them if given)."""
    global LAUNCHES, LAST_SPLIT
    params, grid_x, nby = _params(prog, geom, gp.shape[-geom.ndim], steps)
    member_stride = math.prod(gp.shape[1:]) if batch else 0
    aux_stride = (math.prod(aux_p.shape[1:])
                  if batch and aux_p is not None and aux_p.ndim > geom.ndim
                  else 0)
    bf16, batched = gp.dtype == torch.bfloat16, bool(batch and batch > 1)
    key = _custom_build(dag, geom, bf16, batched)
    dll = (_build.stencil_stream(bf16, batched) if key is None
           else _build.custom_stencil_stream(*key))
    with torch.cuda.device(gp.device):
        split = _split(dll, dag, prog, geom, params, grid_x, batch or 1,
                       member_stride, aux_stride, smem, gp.element_size(),
                       gp.device, segments, key is not None)
        params.seg, params.warm, params.look = (split.seg, split.warm,
                                                split.look)
        grid_y = nby * split.nseg
        stream = torch.cuda.current_stream(gp.device)
        aux_ptr = None if aux_p is None else aux_p.data_ptr()
        if prog.big is None:
            err = dll.stencil_stream_launch(
                prog.body, int(prog.bcs), gp.data_ptr(), aux_ptr,
                out.data_ptr(), params, ctypes.byref(prog.table), grid_x,
                grid_y, batch or 1, member_stride, aux_stride, smem,
                stream.cuda_stream)
        else:
            # the kept table is not reused for another tensor before the
            # kernels of every stream that read it are done
            prog.table.record_stream(stream)
            err = dll.stencil_stream_launch_big(
                prog.body, int(prog.bcs), gp.data_ptr(), aux_ptr,
                out.data_ptr(), params, prog.table.data_ptr(), *prog.big,
                grid_x, grid_y, batch or 1, member_stride, aux_stride, smem,
                stream.cuda_stream)
    if err != 0:
        msg = dll.stencil_stream_error_string(err).decode()
        raise RuntimeError(f"stencil_stream launch failed: {msg} ({err})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
        KERNEL_LAUNCHES[split.kernel] = KERNEL_LAUNCHES.get(split.kernel,
                                                            0) + 1
    LAST_SPLIT = split


# --- plain versions ----------------------------------------------------------

def _extract_blocks(gp: torch.Tensor, geom: BlockGeometry,
                    dom: int) -> torch.Tensor:
    """(ns, *padded) -> (*bnum, dom, *bsize) overlapped blocks of the first
    ``dom`` stream rows: the slab-pad rows past them are never tapped."""
    nb = geom.ndim - 1
    out = gp[:dom]
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


def _reimposer(geom: BlockGeometry, bc, device):
    """The blocked-axis boundary re-imposition of a consumer under ``bc``,
    as a function of ``(*bnum, dom, *bsize)`` blocks, following the TPU
    kernel's ``_reimpose_axis``: along each blocked axis in turn, a
    position outside the grid (block-local edges ``lo = h - start`` and
    ``hi = d - 1 + h - start``; none on interior blocks) takes the edge
    cell's value (clamp), the value mirrored about the edge without
    repeating it (reflect: ``2*lo - x`` or ``2*hi - x``, modulo the block),
    or the fill in the blocks' dtype (constant); a periodic axis is left
    alone, its halo holds wrapped copies."""
    nb = geom.ndim - 1
    steps = []
    for i, kind in enumerate(boundary.kinds_of(bc, geom.ndim)[1:]):
        if kind == "periodic":
            continue
        h, c, b = geom.size_halo, geom.csize[i], geom.bsize[i]
        start = torch.arange(geom.bnum[i], device=device)[:, None] * c
        x = torch.arange(b, device=device)[None, :]
        lo, hi = h - start, geom.blocked_dims[i] - 1 + h - start
        if kind == "constant":
            steps.append((i, None, (x < lo) | (x > hi)))
        elif kind == "reflect":
            steps.append((i, torch.where(
                x > hi, 2 * hi - x, torch.where(x < lo, 2 * lo - x, x)) % b,
                None))
        else:
            steps.append((i, torch.minimum(torch.maximum(x, lo.clamp(min=0)),
                                           hi.clamp(max=b - 1)), None))
    fill = boundary.fill_of(bc)

    def reimpose(blocks: torch.Tensor) -> torch.Tensor:
        for i, idx, mask in steps:
            shape = [1] * blocks.ndim
            shape[i] = geom.bnum[i]
            shape[nb + 1 + i] = geom.bsize[i]
            if mask is not None:
                blocks = torch.where(
                    mask.reshape(shape),
                    torch.tensor(fill, dtype=blocks.dtype, device=device),
                    blocks)
            else:
                blocks = torch.gather(blocks, nb + 1 + i,
                                      idx.reshape(shape).expand(blocks.shape))
        return blocks
    return reimpose


def _block_getter(blocks: torch.Tensor, nb: int, r: int, bc):
    """Neighbour getter on ``(*bnum, dom, *bsize)`` blocks for a stage
    under ``bc``: a stream tap outside ``[0, dom-1]`` clips (clamp, the
    periodic extension), mirrors (reflect) or reads the fill rounded to the
    blocks' dtype (constant), as the TPU kernel's ``stream_tap``;
    blocked-axis taps clip to the block."""
    kind = boundary.kinds_of(bc, nb + 1)[0]
    kind = kind if kind in ("reflect", "constant") else "clamp"
    p = blocks
    if r:
        p = boundary.pad_axis(p, nb, r, r, kind, boundary.fill_of(bc))
        for ax in range(nb + 1, blocks.ndim):
            p = boundary.pad_axis(p, ax, r, r, "clamp")
    lead = (slice(None),) * nb

    def get(off):
        return p[lead + tuple(slice(r + o, r + o + n)
                              for o, n in zip(off, blocks.shape[nb:]))]
    return get


def _stitch(out: torch.Tensor, blocks: torch.Tensor,
            geom: BlockGeometry) -> None:
    """Write each block's compute region of ``(*bnum, dom, *bsize)``
    blocks into the first ``dom`` stream rows of the padded grid ``out``."""
    nb = geom.ndim - 1
    h = geom.size_halo
    comp = blocks[(slice(None),) * (nb + 1)
                  + tuple(slice(h, h + c) for c in geom.csize)]
    # (*bnum, dom, *csize) -> (dom, bn0, cs0, bn1, cs1, ...)
    perm = (nb,) + tuple(x for i in range(nb) for x in (i, nb + 1 + i))
    widths = tuple(n * c for n, c in zip(geom.bnum, geom.csize))
    dom = blocks.shape[nb]
    out[(slice(0, dom),) + tuple(slice(h, h + w) for w in widths)] = (
        comp.permute(perm).reshape((dom,) + widths))


def _stage_coeffs(stencils, coeffs_packed) -> dict:
    """Per stage, its offset into the packed vector (the ``coeff_lo`` of its
    entries) -> ``{name: 0-d tensor}``."""
    out, lo = {}, 0
    for st in stencils:
        n = len(st.coeff_names)
        out[lo] = dict(zip(st.coeff_names,
                           coeffs_packed[lo:lo + n].unbind()))
        lo += n
    return out


def superstep_plain(stages, geom: BlockGeometry, gp: torch.Tensor,
                    coeffs_packed: torch.Tensor, steps: int,
                    aux_p: Optional[torch.Tensor],
                    out: torch.Tensor) -> torch.Tensor:
    """The kernel's chain super-step in torch ops, vectorised over blocks:
    extract the overlapped blocks, run the ``len(stages) * par_time``
    entries in order (entry ``t*S + s`` applies stage ``s`` through
    ``precision.apply_stage`` — taps widened to float32, one rounding to
    the storage dtype — with a getter under that stage's stream-axis
    boundary, or forwards its input when ``t >= steps``), re-impose on
    every value that feeds a next entry the blocked-axis boundary of that
    consumer (:func:`_reimposer`), and write each block's compute region
    into ``out``.  It computes the kernel's values without replaying its
    tick schedule, on the stream rows ``< dom`` only: ``par_vec`` changes
    which rows are padded, not what the real rows hold, and the slab-pad
    rows of ``out`` are left as they were."""
    nb = geom.ndim - 1
    dom = _stream_dom(geom, stages[0][1])
    cdicts = _stage_coeffs([st for st, _ in stages], coeffs_packed)
    reimpose = [_reimposer(geom, bc, gp.device) for _, bc in stages]
    aux_b = None if aux_p is None else _extract_blocks(aux_p, geom, dom)
    cur = _extract_blocks(gp, geom, dom)
    entries = unroll_dag(chain_dag(stages), geom.par_time).entries
    for i, e in enumerate(entries):
        st = e.stencil
        if e.iteration < steps:
            cur = precision.apply_stage(
                st, _block_getter(cur, nb, st.radius, e.bc),
                cdicts[e.coeff_lo], aux_b if st.has_aux else None, gp.dtype)
        if i < len(entries) - 1:
            cur = reimpose[(i + 1) % len(stages)](cur)
    _stitch(out, cur, geom)
    return out


def superstep_dag_plain(dag: DagSpec, geom: BlockGeometry, gp: torch.Tensor,
                        coeffs_packed: torch.Tensor, steps: int,
                        aux_p: Optional[torch.Tensor],
                        out: torch.Tensor) -> torch.Tensor:
    """The kernel's DAG super-step in torch ops, vectorised over blocks: the
    unrolled entries of ``unroll_dag(dag, par_time)`` in order.  A stage
    applies its stencil through ``precision.apply_stage`` with one getter
    per input under its boundary (stages of iterations ``>= steps``
    compute nothing: only the state nodes of their iteration read them,
    and those forward); a state node selects ``inputs[0]`` while its
    iteration is ``< steps``, else ``inputs[1]``; field ``k`` drains from
    ``plan.outputs[k]``, which is its input stream for a field carried
    unchanged.  As the TPU kernel's ``cat_of``, a stage re-imposes every
    input it reads, field streams included, under its own blocked-axis
    boundary (:func:`_reimposer`), and values are kept as computed.  When
    the stages share one boundary, every value that feeds another entry is
    instead re-imposed once, as it is made, under that boundary, which the
    consumers' re-imposition would leave as it is (the kernel's
    single-boundary DAG body; the two differ only outside the grid).  As
    in the chain, only stream rows ``< dom`` are computed and written.  A
    path graph runs as :func:`superstep_plain`.  A batch (a leading axis,
    aux shared or per member) runs member by member, so it equals ``B``
    single calls bit for bit."""
    bc0 = dag.stages[0][1]
    if batch_of(_stream_shape(geom, bc0, dag.n_fields), gp) is not None:
        per_member = aux_p is not None and aux_p.ndim > geom.ndim
        for b in range(gp.shape[0]):
            superstep_dag_plain(dag, geom, gp[b], coeffs_packed, steps,
                                aux_p[b] if per_member else aux_p, out[b])
        return out
    stages = _as_chain(dag)
    if stages is not None:
        return superstep_plain(stages, geom, gp, coeffs_packed, steps, aux_p,
                               out)
    plan = unroll_dag(dag, geom.par_time)
    lay = dag_layout(plan, geom.par_vec)
    F = plan.n_streams
    nb = geom.ndim - 1
    dom = _stream_dom(geom, bc0)
    cdicts = _stage_coeffs([st for st, _, _ in dag.stages], coeffs_packed)
    mixed = mixes_boundaries(dag, geom.ndim)
    reimposers = {}

    def reimposer(bc):
        key = _bc_key(bc, geom.ndim)
        if key not in reimposers:
            reimposers[key] = _reimposer(geom, bc, gp.device)
        return reimposers[key]
    aux_b = None if aux_p is None else _extract_blocks(aux_p, geom, dom)
    fields = (gp,) if F == 1 else gp.unbind(0)
    vals = [_extract_blocks(f, geom, dom) for f in fields] + [None] * len(
        plan.entries)
    last_read = {p: i for i, e in enumerate(plan.entries) for p in e.inputs}
    keep = set(plan.outputs)
    for i, e in enumerate(plan.entries):
        v = F + i
        st = e.stencil
        if st is None:
            val = vals[e.inputs[0] if e.iteration < steps else e.inputs[1]]
        elif e.iteration < steps:
            ins = ({p: reimposer(e.bc)(vals[p]) for p in e.inputs}
                   if mixed else vals)
            gets = [_block_getter(ins[p], nb, st.radius, e.bc)
                    for p in e.inputs]
            val = precision.apply_stage(
                st, tuple(gets) if st.arity > 1 else gets[0],
                cdicts[e.coeff_lo], aux_b if st.has_aux else None, gp.dtype)
        else:
            val = None
        if val is not None and lay.wins[v] and not mixed:
            val = reimposer(bc0)(val)
        vals[v] = val
        for p in set(e.inputs):       # free what no later entry reads
            if last_read[p] == i and p not in keep:
                vals[p] = None
    outs = (out,) if F == 1 else out.unbind(0)
    for o, dst in zip(plan.outputs, outs):
        _stitch(dst, vals[o], geom)
    return out
