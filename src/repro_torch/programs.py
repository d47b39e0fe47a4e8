"""Unroll and window arithmetic of the fused streaming super-step.

A super-step unrolls ``par_time`` iterations of a stage DAG into a value
graph of :class:`DagNode` entries (:func:`unroll_dag`);
:func:`dag_layout` derives each value's lag behind the input stream and
each producer's circular-window depth (StencilFlow's buffer-depth
analysis).  The CUDA launcher reads the tick count and window depths from
here.  The user-facing ``StencilStage``/``StencilProgram`` wait for the
multi-stage slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.boundary import BoundaryCondition
from repro_torch.core.stencils import Stencil


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """Static execution form of a stage DAG.

    ``stages[i] = (stencil, bc, refs)`` in authored order; ``refs`` encode
    inputs (``r >= 0`` reads stage ``r``, ``r < 0`` reads field ``~r``).
    ``updates[k]`` is field ``k``'s next value in the same encoding;
    ``topo`` is a topological order of the stages."""
    stages: Tuple[Tuple[Stencil, Optional[BoundaryCondition],
                        Tuple[int, ...]], ...]
    n_fields: int
    updates: Tuple[int, ...]
    topo: Tuple[int, ...]


def chain_dag(stages) -> DagSpec:
    """The path-graph :class:`DagSpec` of a linear chain of
    ``(stencil, bc)`` pairs."""
    L = len(stages)
    return DagSpec(
        stages=tuple((st, bc, ((i - 1,) if i else (-1,)))
                     for i, (st, bc) in enumerate(stages)),
        n_fields=1, updates=(L - 1,), topo=tuple(range(L)))


def dag_is_chain(dag: DagSpec) -> bool:
    """True iff ``dag`` is the single-field path graph."""
    L = len(dag.stages)
    return (dag.n_fields == 1 and dag.updates == (L - 1,)
            and all(st.arity == 1
                    and refs == ((i - 1,) if i else (-1,))
                    for i, (st, _, refs) in enumerate(dag.stages)))


@dataclasses.dataclass(frozen=True)
class DagNode:
    """One value node of the unrolled super-step graph.  ``stencil is None``
    marks a state (select) node of a general DAG; linear chains fuse the
    PE-forwarding select into every entry (``fused_select``).  ``inputs``
    are value ids: ``0..n_streams-1`` are the field streams,
    ``n_streams + e`` is entry ``e``."""
    stencil: Optional[Stencil]
    bc: object                    # BoundaryCondition or None (= clamp)
    coeff_lo: int                 # slice start into the packed coeff vector
    inputs: Tuple[int, ...]
    iteration: int                # which iteration this entry belongs to
    fused_select: bool = False


@dataclasses.dataclass(frozen=True)
class UnrollPlan:
    """``par_time`` iterations of a :class:`DagSpec` as a value graph;
    ``outputs[k]`` is the value id field ``k`` holds after the super-step."""
    n_streams: int
    entries: Tuple[DagNode, ...]
    outputs: Tuple[int, ...]
    linear: bool


def unroll_dag(dag: DagSpec, par_time: int) -> UnrollPlan:
    """Topological unroll of ``par_time`` repeats of the DAG."""
    F = dag.n_fields
    L = len(dag.stages)
    los, acc = [], 0
    for st, _, _ in dag.stages:
        los.append(acc)
        acc += len(st.coeff_names)
    linear = dag_is_chain(dag)
    entries = []
    cur = list(range(F))          # value id currently holding each field

    def vid():
        return F + len(entries)

    for t in range(par_time):
        vals: list = [None] * L
        for si in dag.topo:
            st, bc, refs = dag.stages[si]
            ins = tuple(vals[r] if r >= 0 else cur[~r] for r in refs)
            v = vid()
            entries.append(DagNode(st, bc, los[si], ins, t,
                                   fused_select=linear))
            vals[si] = v
        if linear:
            cur[0] = vals[L - 1]
            continue
        new = list(cur)
        for k, u in enumerate(dag.updates):
            if u == ~k:           # field carried unchanged: no node
                continue
            src = vals[u] if u >= 0 else cur[~u]
            new[k] = vid()
            entries.append(DagNode(None, None, -1, (src, cur[k]), t))
        cur = new
    return UnrollPlan(F, tuple(entries), tuple(cur), linear)


@dataclasses.dataclass(frozen=True)
class DagLayout:
    """Buffer-depth analysis of an :class:`UnrollPlan` at vector width
    ``V``: entry ``v`` computes slab ``k - lags[v]`` at tick ``k``;
    ``wins[v]`` is the slot count of producer ``v``'s window (0 = no
    window: the value only feeds the output)."""
    radii: Tuple[int, ...]        # per entry (slabs); state nodes are 0
    lags: Tuple[int, ...]         # per value id
    wins: Tuple[int, ...]         # per value id
    out_lag: int                  # max lag over output producers
    aux_depth: int                # aux window depth, in slabs


def dag_layout(plan: UnrollPlan, par_vec: int) -> DagLayout:
    F = plan.n_streams
    radii = tuple(0 if e.stencil is None
                  else -(-e.stencil.radius // par_vec)
                  for e in plan.entries)
    lags = [0] * (F + len(plan.entries))
    for i, e in enumerate(plan.entries):
        lags[F + i] = radii[i] + max((lags[p] for p in e.inputs), default=0)
    wins = [0] * (F + len(plan.entries))
    for i, e in enumerate(plan.entries):
        need = lags[F + i] + radii[i] + 1
        for p in set(e.inputs):
            wins[p] = max(wins[p], need - lags[p])
    out_lag = max(lags[o] for o in plan.outputs)
    if plan.linear:
        aux_depth = lags[-1] + 1
    else:
        al = [lags[F + i] for i, e in enumerate(plan.entries)
              if e.stencil is not None and e.stencil.has_aux]
        aux_depth = (max(al) + 1) if al else 1
    return DagLayout(radii, tuple(lags), tuple(wins), out_lag, aux_depth)
