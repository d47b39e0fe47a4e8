"""Declarative problem description — what to compute, not how."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import precision
from repro_torch.core.boundary import BCSpec, BoundaryCondition
from repro_torch.core.stencils import STENCILS, Stencil, default_coeffs


@dataclasses.dataclass(frozen=True)
class StencilProblem:
    """An iterated-stencil computation on a fixed grid.

    ``stencil`` is a :class:`~repro_torch.core.stencils.Stencil` or a
    registered name; ``shape`` the grid extents, streaming axis first;
    ``dtype`` the storage dtype; ``boundary`` one kind for every axis, a
    per-axis sequence, or a ``BoundaryCondition`` (default: the paper's
    clamp); ``aux`` must agree with ``stencil.has_aux`` when given.
    Multi-stage programs are not ported yet (ROADMAP A12)."""
    stencil: Union[Stencil, str]
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
            raise NotImplementedError(
                "stencil programs (StencilProgram, StencilStage, stage "
                "sequences) are not ported yet (ROADMAP A12); pass a Stencil"
                " or a registered stencil name")
        object.__setattr__(self, "stencil", st)
        shape = tuple(int(d) for d in self.shape)
        object.__setattr__(self, "shape", shape)
        if len(shape) != st.ndim:
            raise ValueError(f"{st.name} is {st.ndim}D but shape={shape}")
        if any(d < 1 for d in shape):
            raise ValueError(f"non-positive grid extent in {shape}")
        bc = BoundaryCondition.make(self.boundary, st.ndim)
        bc.validate_shape(shape)
        object.__setattr__(self, "boundary", bc)
        object.__setattr__(self, "dtype",
                           precision.normalize_dtype(self.dtype))
        if self.aux is not None and bool(self.aux) != st.has_aux:
            raise ValueError(f"aux={self.aux} conflicts with {st.name} "
                             f"(stencil.has_aux={st.has_aux})")

    @property
    def bc(self) -> BoundaryCondition:
        return self.boundary

    @property
    def structural_bc(self) -> BoundaryCondition:
        """The BC that sizes padding and the periodic stream extension."""
        return self.boundary

    @property
    def exec_stages(self) -> Tuple[Tuple[Stencil, BoundaryCondition], ...]:
        """The ``((stencil, bc),)`` chain the executors take."""
        return ((self.stencil, self.boundary),)

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

    def resolve_coeffs(self, coeffs=None, device="cpu") -> dict:
        """Default coefficients overlaid with ``coeffs``, as 0-d tensors of
        the accumulation dtype on ``device``.  Unknown names are
        rejected."""
        merged = default_coeffs(self.stencil, self.accum_dtype)
        if coeffs:
            unknown = [k for k in coeffs if k not in merged]
            if unknown:
                raise ValueError(
                    f"unknown coefficients {unknown} for {self.stencil.name} "
                    f"(has {list(self.stencil.coeff_names)})")
            merged.update(coeffs)
        return {k: torch.as_tensor(v, dtype=self.accum_dtype)
                .to(device).reshape(()) for k, v in merged.items()}
