"""Declarative problem description — what to compute, not how."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import precision
from repro_torch.core.boundary import BCSpec, BoundaryCondition
from repro_torch.core.stencils import STENCILS, Stencil, default_coeffs
from repro_torch.programs import DagSpec, StencilProgram, StencilStage


@dataclasses.dataclass(frozen=True)
class StencilProblem:
    """An iterated-stencil computation on a fixed grid.

    ``stencil`` is a :class:`~repro_torch.core.stencils.Stencil`, a
    registered name, or a program: a
    :class:`~repro_torch.programs.StencilProgram`, a
    :class:`~repro_torch.programs.StencilStage` or a sequence of
    stage-likes.  A lone plain stage normalizes back to the bare stencil;
    any other program is kept in its resolved form (per-stage
    ``BoundaryCondition``s), which duck-types the ``Stencil`` bookkeeping.
    :attr:`program` always gives the resolved program.  ``shape`` is the
    grid extents, streaming axis first; ``dtype`` the storage dtype;
    ``boundary`` one kind for every axis, a per-axis sequence, or a
    ``BoundaryCondition`` (default: the paper's clamp); ``aux`` must agree
    with ``stencil.has_aux`` when given."""
    stencil: Union[Stencil, str, StencilProgram, StencilStage, Sequence]
    shape: Tuple[int, ...]
    dtype: str = "float32"
    boundary: BCSpec = "clamp"
    aux: Optional[bool] = None

    def __post_init__(self):
        st = self.stencil
        if isinstance(st, str):
            if st not in STENCILS:
                raise ValueError(f"unknown stencil {st!r}; "
                                 f"registered: {sorted(STENCILS)}")
            st = STENCILS[st]
        elif not isinstance(st, Stencil):
            st = StencilProgram.make(st)
        shape = tuple(int(d) for d in self.shape)
        object.__setattr__(self, "shape", shape)
        if len(shape) != st.ndim:
            raise ValueError(f"{st.name} is {st.ndim}D but shape={shape}")
        if any(d < 1 for d in shape):
            raise ValueError(f"non-positive grid extent in {shape}")
        bc = BoundaryCondition.make(self.boundary, st.ndim)
        bc.validate_shape(shape)
        object.__setattr__(self, "boundary", bc)
        if isinstance(st, StencilProgram):
            program = st.resolved(bc, shape)
            if (len(program) == 1 and program.is_linear
                    and program.stages[0].coeffs is None
                    and program.stages[0].boundary == bc):
                st = program.stages[0].stencil    # a plain lone stage
            else:
                st = program
        else:
            program = StencilProgram((StencilStage(st, boundary=bc),))
        object.__setattr__(self, "stencil", st)
        object.__setattr__(self, "_program", program)
        object.__setattr__(self, "dtype",
                           precision.normalize_dtype(self.dtype))
        if self.aux is not None and bool(self.aux) != st.has_aux:
            raise ValueError(f"aux={self.aux} conflicts with {st.name} "
                             f"(stencil.has_aux={st.has_aux})")

    @property
    def bc(self) -> BoundaryCondition:
        """The problem-level BC (stages may override it)."""
        return self.boundary

    @property
    def program(self) -> StencilProgram:
        """The resolved program form: every problem is a (possibly
        single-stage) program with per-stage ``BoundaryCondition``s."""
        return self._program

    @property
    def stages(self) -> Tuple[StencilStage, ...]:
        return self._program.stages

    @property
    def n_stages(self) -> int:
        return len(self._program)

    @property
    def is_program(self) -> bool:
        """True for more than a bare stencil: several stages, or one stage
        with coefficient or BC overrides."""
        return isinstance(self.stencil, StencilProgram)

    @property
    def is_dag(self) -> bool:
        """True when the program is not a default-wired single-field
        chain."""
        return not self._program.is_linear

    @property
    def fields(self) -> Tuple[str, ...]:
        return self._program.fields

    @property
    def state_shape(self) -> Tuple[int, ...]:
        """Shape of the state ``run`` takes: ``shape`` for one field,
        ``(n_fields, *shape)`` otherwise (fields in declaration order)."""
        F = len(self._program.fields)
        return ((F,) + self.shape) if F > 1 else self.shape

    @property
    def structural_bc(self) -> BoundaryCondition:
        """Stage 0's BC: what sizes padding and the periodic stream
        extension (periodicity is uniform across stages)."""
        return self.stages[0].boundary

    @property
    def exec_stages(self) -> Tuple[Tuple[Stencil, BoundaryCondition], ...]:
        """The ``((stencil, bc), ...)`` chain the executors take."""
        return tuple((s.stencil, s.boundary) for s in self.stages)

    @property
    def exec_dag(self) -> DagSpec:
        """The resolved program's :class:`~repro_torch.programs.DagSpec`."""
        return self._program.dag

    @property
    def ndim(self) -> int:
        return self.stencil.ndim

    @property
    def needs_aux(self) -> bool:
        return self.stencil.has_aux

    @property
    def torch_dtype(self) -> torch.dtype:
        return precision.torch_dtype(self.dtype)

    @property
    def accum_dtype(self) -> torch.dtype:
        return precision.accum_dtype(self.dtype)

    @property
    def cell_bytes(self) -> int:
        return precision.cell_bytes(self.dtype)

    def resolve_coeffs(self, coeffs=None, device="cpu") -> Tuple[dict, ...]:
        """One coefficient dict per stage: the stencil defaults, overlaid
        with the stage's overrides, overlaid with run-time ``coeffs`` (a
        dict for a single-stage problem, else a sequence of per-stage
        dicts or ``None``), as 0-d tensors of the accumulation dtype on
        ``device``.  Unknown names are rejected."""
        if coeffs is None:
            per_stage = (None,) * self.n_stages
        elif isinstance(coeffs, dict):
            if self.n_stages > 1:
                raise ValueError(
                    f"{self.stencil.name} has {self.n_stages} stages: pass "
                    "coeffs as a sequence of per-stage dicts (None entries "
                    "keep that stage's defaults), not a single dict")
            per_stage = (coeffs,)
        else:
            per_stage = tuple(coeffs)
            if len(per_stage) != self.n_stages:
                raise ValueError(f"got {len(per_stage)} coefficient dicts "
                                 f"for {self.n_stages} stages")
        out = []
        for stage, run_c in zip(self.stages, per_stage):
            merged = default_coeffs(stage.stencil, self.accum_dtype)
            if stage.coeffs:
                merged.update(stage.coeffs)
            if run_c:
                unknown = [k for k in run_c if k not in merged]
                if unknown:
                    raise ValueError(
                        f"unknown coefficients {unknown} for stage "
                        f"{stage.name} (has "
                        f"{list(stage.stencil.coeff_names)})")
                merged.update(run_c)
            out.append({k: torch.as_tensor(v, dtype=self.accum_dtype)
                        .to(device).reshape(()) for k, v in merged.items()})
        return tuple(out)
