"""Multi-stage stencil programs and the unroll arithmetic of the fused
streaming super-step.

:class:`StencilStage` is one operator application (a stencil plus optional
per-stage coefficient overrides, boundary condition and input references);
:class:`StencilProgram` a validated DAG of stages over named fields, with
per-field ``updates``.  One iteration evaluates the stages in topological
order and then updates every field at once.  Default wiring is a linear
chain (one field ``"u"``, stage ``i`` reads stage ``i-1``):
:attr:`StencilProgram.is_linear`.  A program duck-types the ``Stencil``
bookkeeping the planning layers read (``radius`` is the DAG's critical-path
cumulative radius, ``flop_pcu`` the sum over stages, ``num_read`` one
stream per field plus aux).  Each stage reads its inputs under its own
boundary condition; per-axis periodicity must be uniform across stages.

The bottom half unrolls ``par_time`` iterations of a stage DAG into a value
graph of :class:`DagNode` entries (:func:`unroll_dag`);
:func:`dag_layout` derives each value's lag behind the input stream and
each producer's circular-window depth (StencilFlow's buffer-depth
analysis).  The CUDA launcher reads the entry table, lags and window
depths from here, and ``core/blocking.smem_bytes`` prices the windows.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.boundary import BCSpec, BoundaryCondition
from repro_torch.core.stencils import STENCILS, Stencil


def _freeze_coeffs(coeffs) -> Optional[Tuple[Tuple[str, float], ...]]:
    """A stage's coefficient overrides as a hashable, order-independent
    tuple of ``(name, value)`` pairs."""
    if coeffs is None:
        return None
    if isinstance(coeffs, tuple):   # already frozen: idempotent under
        items = coeffs              # dataclasses.replace
    elif isinstance(coeffs, Mapping):
        items = coeffs.items()
    else:
        raise TypeError(f"stage coeffs must be a mapping, got "
                        f"{type(coeffs).__name__}")
    return tuple(sorted((str(k), float(v)) for k, v in items))


@dataclasses.dataclass(frozen=True)
class StencilStage:
    """One stage of a program.

    ``stencil`` is a :class:`~repro_torch.core.stencils.Stencil` or a
    registered name; ``coeffs`` optional overrides merged over the defaults
    (and under run-time ``coeffs``); ``boundary`` an optional per-stage BC
    (``None`` inherits the problem's); ``name`` a label for reports and
    ``inputs`` references (default: the stencil name; ``stage0``,
    ``stage1``, ... always resolve); ``inputs`` the field or stage names
    the stencil reads, one per input (``None``: the previous stage, or the
    first field for stage 0).  A multi-input stencil needs ``inputs``."""
    stencil: Union[Stencil, str]
    coeffs: Optional[Mapping] = None
    boundary: Optional[BCSpec] = None
    name: Optional[str] = None
    inputs: Optional[Sequence[str]] = None

    def __post_init__(self):
        st = self.stencil
        if isinstance(st, str):
            if st not in STENCILS:
                raise ValueError(f"unknown stencil {st!r}; "
                                 f"registered: {sorted(STENCILS)}")
            st = STENCILS[st]
            object.__setattr__(self, "stencil", st)
        elif not isinstance(st, Stencil):
            raise TypeError(f"stage stencil must be a Stencil or name, got "
                            f"{type(st).__name__}")
        frozen = _freeze_coeffs(self.coeffs)
        if frozen:
            unknown = [k for k, _ in frozen if k not in st.coeff_names]
            if unknown:
                raise ValueError(
                    f"stage coeffs {unknown} are not coefficients of "
                    f"{st.name} (has {list(st.coeff_names)})")
        object.__setattr__(self, "coeffs", frozen)
        if isinstance(self.boundary, list):
            object.__setattr__(self, "boundary", tuple(self.boundary))
        if self.name is None:
            object.__setattr__(self, "name", st.name)
        if self.inputs is not None:
            ins = self.inputs
            if isinstance(ins, str):
                ins = (ins,)
            ins = tuple(str(r) for r in ins)
            if len(ins) != st.arity:
                raise ValueError(
                    f"stage {self.name!r}: {len(ins)} inputs given but "
                    f"stencil {st.name} has arity {st.arity}")
            object.__setattr__(self, "inputs", ins)

    @property
    def bc(self) -> Optional[BoundaryCondition]:
        """The stage BC once normalized (a resolved program), else None."""
        b = self.boundary
        return b if isinstance(b, BoundaryCondition) else None


#: anything :meth:`StencilProgram.make` accepts as one stage
StageLike = Union[StencilStage, Stencil, str]


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


def dag_radius(dag: DagSpec) -> int:
    """Per-iteration halo growth: the critical-path cumulative radius over
    the DAG, maximized over the field updates (the sum of the stage radii
    for a chain)."""
    cum = [0] * len(dag.stages)
    for si in dag.topo:
        st, _, refs = dag.stages[si]
        cum[si] = st.radius + max((cum[r] for r in refs if r >= 0), default=0)
    return max((cum[u] for u in dag.updates if u >= 0), default=0)


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


@dataclasses.dataclass(frozen=True)
class StencilProgram:
    """A validated DAG of :class:`StencilStage` over named external fields.

    One iteration evaluates the stages in topological order, each reading
    its ``inputs`` (fields or other stages), then applies ``updates``
    (``{field: stage-or-field name}``) to every field at once.  Defaults
    give the linear chain: one field ``"u"``, stage ``i`` reads stage
    ``i-1``, the field takes the last stage's value.

    Construction rejects dangling or ambiguous references, arity
    mismatches, cycles (Kahn toposort) and stages whose output nobody
    consumes."""
    stages: Tuple[StencilStage, ...]
    fields: Tuple[str, ...] = ("u",)
    updates: Optional[Mapping] = None

    def __post_init__(self):
        stages = tuple(s if isinstance(s, StencilStage) else StencilStage(s)
                       for s in self.stages)
        if not stages:
            raise ValueError("a StencilProgram needs at least one stage")
        nd = stages[0].stencil.ndim
        for s in stages:
            if s.stencil.ndim != nd:
                raise ValueError(
                    f"all stages must share a rank: got {nd}D and "
                    f"{s.stencil.ndim}D ({s.name})")
        object.__setattr__(self, "stages", stages)

        fields = self.fields
        if isinstance(fields, str):
            fields = (fields,)
        fields = tuple(str(f) for f in fields)
        if not fields:
            raise ValueError("a StencilProgram needs at least one field")
        if len(set(fields)) != len(fields):
            raise ValueError(f"duplicate field names in {fields}")
        object.__setattr__(self, "fields", fields)

        # updates as a per-field-ordered tuple of (field, ref)
        upd = self.updates
        if upd is not None:
            if isinstance(upd, Mapping):
                items = list(upd.items())
            elif isinstance(upd, tuple) and all(
                    isinstance(p, tuple) and len(p) == 2 for p in upd):
                items = list(upd)       # already frozen: idempotent
            else:
                raise TypeError("updates must be a mapping "
                                "{field: stage-or-field name}")
            for f, _ in items:
                if f not in fields:
                    raise ValueError(f"updates key {f!r} is not a field "
                                     f"(fields: {list(fields)})")
            by_field = dict((str(f), str(r)) for f, r in items)
            upd = tuple((f, by_field[f]) for f in fields if f in by_field)
            object.__setattr__(self, "updates", upd)

        self._resolve_dag()

    # --- DAG resolution and validation ---------------------------------------
    def _resolve_dag(self) -> None:
        stages, fields = self.stages, self.fields
        L = len(stages)
        field_pos = {f: k for k, f in enumerate(fields)}
        auto = {f"stage{i}": i for i in range(L)}
        counts = Counter(s.name for s in stages)
        by_name = {s.name: i for i, s in enumerate(stages)
                   if counts[s.name] == 1}

        def resolve(ref: str, where: str) -> int:
            si = auto.get(ref, by_name.get(ref))
            fi = field_pos.get(ref)
            if si is not None and fi is not None:
                raise ValueError(
                    f"{where}: reference {ref!r} is ambiguous — it names "
                    f"both a field and a stage; rename one or use the "
                    f"positional alias stage{si}")
            if si is not None:
                return si
            if fi is not None:
                return ~fi
            if counts.get(ref, 0) > 1:
                raise ValueError(
                    f"{where}: reference {ref!r} is ambiguous — "
                    f"{counts[ref]} stages share that name; use the "
                    f"positional aliases stage0..stage{L - 1}")
            raise ValueError(
                f"{where}: dangling reference {ref!r} — not a field "
                f"{list(fields)} or a stage "
                f"{sorted(set(auto) | set(by_name))}")

        inputs_idx = []
        for i, s in enumerate(stages):
            if s.inputs is None:
                if s.stencil.arity != 1:
                    raise ValueError(
                        f"stage {s.name!r} (stage{i}): stencil "
                        f"{s.stencil.name} has arity {s.stencil.arity} and "
                        f"needs explicit inputs=(...)")
                inputs_idx.append(((i - 1,) if i else (~0,)))
            else:
                inputs_idx.append(tuple(
                    resolve(r, f"stage {s.name!r} (stage{i}) inputs")
                    for r in s.inputs))
        inputs_idx = tuple(inputs_idx)

        if self.updates is None:
            updates_idx = tuple((L - 1) if k == 0 else ~k
                                for k in range(len(fields)))
        else:
            declared = dict(self.updates)
            updates_idx = tuple(
                resolve(declared[f], f"updates[{f!r}]") if f in declared
                else ~k
                for k, f in enumerate(fields))

        # Kahn toposort over stage->stage edges (authored order preserved;
        # forward references are legal, cycles are not)
        preds = [sorted({r for r in ins if r >= 0}) for ins in inputs_idx]
        indeg = [len(p) for p in preds]
        succs = [[] for _ in range(L)]
        for i, ps in enumerate(preds):
            for p in ps:
                succs[p].append(i)
        ready = sorted(i for i in range(L) if not indeg[i])
        topo = []
        while ready:
            i = ready.pop(0)
            topo.append(i)
            for c in succs[i]:
                indeg[c] -= 1
                if not indeg[c]:
                    ready.append(c)
            ready.sort()
        if len(topo) != L:
            stuck = [f"stage{i}({stages[i].name})"
                     for i in range(L) if i not in topo]
            raise ValueError(f"program DAG has a cycle through {stuck}")

        consumed = {r for ins in inputs_idx for r in ins if r >= 0}
        consumed |= {u for u in updates_idx if u >= 0}
        unused = [i for i in range(L) if i not in consumed]
        if unused:
            raise ValueError(
                "stage output(s) never consumed (dead stages): "
                + ", ".join(f"stage{i}({stages[i].name})" for i in unused))

        linear = (len(fields) == 1
                  and updates_idx == (L - 1,)
                  and all(s.stencil.arity == 1 for s in stages)
                  and all(inputs_idx[i] == ((i - 1,) if i else (~0,))
                          for i in range(L)))
        object.__setattr__(self, "_inputs_idx", inputs_idx)
        object.__setattr__(self, "_updates_idx", updates_idx)
        object.__setattr__(self, "_topo", tuple(topo))
        object.__setattr__(self, "_linear", linear)

    # --- construction --------------------------------------------------------
    @classmethod
    def make(cls, spec: Union["StencilProgram", StageLike,
                              Sequence[StageLike]]) -> "StencilProgram":
        """A program from a program (as is), one stencil, name or stage, or
        a sequence of them."""
        if isinstance(spec, StencilProgram):
            return spec
        if isinstance(spec, (StencilStage, Stencil, str)):
            return cls((spec if isinstance(spec, StencilStage)
                        else StencilStage(spec),))
        if isinstance(spec, Sequence):
            return cls(tuple(s if isinstance(s, StencilStage)
                             else StencilStage(s) for s in spec))
        raise TypeError(f"cannot build a StencilProgram from "
                        f"{type(spec).__name__}")

    def resolved(self, default_boundary: BCSpec,
                 shape: Tuple[int, ...]) -> "StencilProgram":
        """The program with every stage BC a :class:`BoundaryCondition`
        (``None`` takes ``default_boundary``), validated against ``shape``;
        per-axis periodicity must be uniform across stages."""
        nd = self.ndim
        default_bc = BoundaryCondition.make(default_boundary, nd)
        out = []
        for s in self.stages:
            bc = (default_bc if s.boundary is None
                  else BoundaryCondition.make(s.boundary, nd))
            bc.validate_shape(shape)
            out.append(dataclasses.replace(s, boundary=bc))
        for ax in range(nd):
            per = {s.boundary.kinds[ax] == "periodic" for s in out}
            if len(per) > 1:
                raise ValueError(
                    f"axis {ax}: stages mix periodic and non-periodic BCs "
                    f"({[s.boundary.kinds[ax] for s in out]}) — periodicity "
                    "is structural (the padded layout and the stream "
                    "extension) and must be uniform across a program's "
                    "stages")
        return dataclasses.replace(self, stages=tuple(out))

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self):
        return iter(self.stages)

    # --- DAG views -----------------------------------------------------------
    @property
    def is_linear(self) -> bool:
        """True for single-field chains with the default wiring."""
        return self._linear

    @property
    def inputs_idx(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-stage input references (``>= 0`` a stage, ``< 0`` field
        ``~r``)."""
        return self._inputs_idx

    @property
    def updates_idx(self) -> Tuple[int, ...]:
        """Per-field next-value references (``~k``: unchanged)."""
        return self._updates_idx

    @property
    def topo(self) -> Tuple[int, ...]:
        return self._topo

    @property
    def dag(self) -> DagSpec:
        """The execution form the executors take (stage BCs as carried:
        resolve the program first)."""
        return DagSpec(
            stages=tuple((s.stencil, s.bc, self._inputs_idx[i])
                         for i, s in enumerate(self.stages)),
            n_fields=len(self.fields),
            updates=self._updates_idx,
            topo=self._topo)

    # --- Stencil duck-typed aggregates ---------------------------------------
    @property
    def ndim(self) -> int:
        return self.stages[0].stencil.ndim

    @property
    def name(self) -> str:
        if len(self.stages) == 1 and self._linear:
            return self.stages[0].stencil.name
        return "program(" + "+".join(s.name for s in self.stages) + ")"

    @property
    def stage_radii(self) -> Tuple[int, ...]:
        return tuple(s.stencil.radius for s in self.stages)

    @property
    def radius(self) -> int:
        """Per-iteration halo growth (the sum of stage radii for a chain):
        the ``rad`` that sizes ``size_halo = rad * par_time``."""
        return dag_radius(self.dag)

    @property
    def flop_pcu(self) -> int:
        return sum(s.stencil.flop_pcu for s in self.stages)

    @property
    def has_aux(self) -> bool:
        return any(s.stencil.has_aux for s in self.stages)

    @property
    def num_read(self) -> int:
        """External input streams per cell: one per field, plus aux.
        Intermediates never touch device memory."""
        return len(self.fields) + (1 if self.has_aux else 0)

    @property
    def num_write(self) -> int:
        return len(self.fields)
