"""Per-axis boundary conditions — clamp / periodic / reflect / constant.

  ``clamp``      out-of-grid index i -> clip(i, 0, n-1)          (paper §5.1)
  ``periodic``   i -> i mod n
  ``reflect``    i -> mirror about the edge cells, edge not repeated
                 (numpy ``mode="reflect"``: -1 -> 1, n -> n-2)
  ``constant``   out-of-grid neighbours read a fixed scalar fill value

Axes may mix kinds; each axis' rule applies to its own coordinate, and a
``constant`` axis absorbs.  Sequential per-axis padding defines the ground
truth (``kernels/ref.py``).

Padding is built from :func:`map_index` gathers, not ``F.pad``: the
``reflect`` and ``circular`` modes of ``F.pad`` refuse pads wider than the
axis, and numpy's pad modes — which the reference package uses — accept
them.  A gather through the mirrored or wrapped index map gives numpy's
result for any pad width.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

#: Supported per-axis boundary kinds.
KINDS = ("clamp", "periodic", "reflect", "constant")

#: Spec forms accepted by :meth:`BoundaryCondition.make` / StencilProblem.
BCSpec = Union[str, Sequence[str], "BoundaryCondition"]


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """Per-axis boundary condition (streaming axis first, like grid shapes).

    ``kinds`` has one entry per grid axis; ``value`` is the shared scalar
    fill for ``constant`` axes."""
    kinds: Tuple[str, ...]
    value: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "kinds", tuple(self.kinds))
        for k in self.kinds:
            if k not in KINDS:
                raise ValueError(f"unknown boundary kind {k!r}; "
                                 f"supported: {KINDS}")
        try:
            v = float(self.value)
        except (TypeError, ValueError):
            raise ValueError(
                f"constant boundary fill must be a scalar, got "
                f"{self.value!r} ({type(self.value).__name__})") from None
        object.__setattr__(self, "value", v)

    @classmethod
    def make(cls, spec: BCSpec, ndim: int) -> "BoundaryCondition":
        """Normalize a user spec: one kind name for every axis, a per-axis
        sequence of kind names, or a ``BoundaryCondition``.  A
        ``"constant:VALUE"`` token sets the fill value inline."""
        if isinstance(spec, BoundaryCondition):
            if len(spec.kinds) != ndim:
                raise ValueError(f"boundary has {len(spec.kinds)} axis kinds "
                                 f"but the grid is {ndim}D")
            return spec
        if isinstance(spec, str):
            entries = (spec,) * ndim
        else:
            entries = tuple(spec)
            if len(entries) != ndim:
                raise ValueError(f"boundary {entries!r} has {len(entries)} "
                                 f"entries; need one per grid axis ({ndim})")
        kinds, values = [], []
        for e in entries:
            if not isinstance(e, str):
                raise ValueError(f"per-axis boundary entries must be kind "
                                 f"names, got {e!r}")
            kind, _, val = e.partition(":")
            kinds.append(kind)
            if val:
                if kind != "constant":
                    raise ValueError(f"only 'constant' takes a ':value' "
                                     f"suffix, got {e!r}")
                try:
                    values.append(float(val))
                except ValueError:
                    raise ValueError(
                        f"boundary spec {e!r}: the constant fill must be "
                        f"a number (e.g. 'constant:80.0')") from None
        if len(set(values)) > 1:
            raise ValueError(f"conflicting constant fill values {values}; "
                             "all constant axes share one scalar")
        return cls(tuple(kinds), values[0] if values else 0.0)

    @classmethod
    def clamp(cls, ndim: int) -> "BoundaryCondition":
        """The paper's default: edge replication on every axis."""
        return cls(("clamp",) * ndim)

    @property
    def is_clamp(self) -> bool:
        return all(k == "clamp" for k in self.kinds)

    def token(self) -> str:
        """Stable human-readable identity for reprs and error messages."""
        toks = [f"constant({self.value:g})" if k == "constant" else k
                for k in self.kinds]
        return toks[0] if len(set(toks)) == 1 else ",".join(toks)

    def validate_shape(self, shape: Sequence[int]) -> None:
        """``reflect`` mirrors about the edge cells without repeating them,
        which needs at least 2 cells on that axis."""
        for ax, (k, d) in enumerate(zip(self.kinds, shape)):
            if k == "reflect" and d < 2:
                raise ValueError(
                    f"'reflect' boundary on axis {ax} needs extent >= 2 "
                    f"(got {d}); use 'clamp' for degenerate axes")


def kinds_of(bc, ndim: int) -> Tuple[str, ...]:
    """Per-axis kinds with ``None`` meaning the default (clamp)."""
    return ("clamp",) * ndim if bc is None else bc.kinds


def fill_of(bc) -> float:
    return 0.0 if bc is None else bc.value


def map_index(idx: torch.Tensor, lo: int, hi: int,
              kind: str) -> torch.Tensor:
    """Map (possibly out-of-range) coordinates into ``[lo, hi]`` per the BC's
    index rule.  ``constant`` has no index rule — callers mask instead."""
    if kind == "periodic":
        return lo + torch.remainder(idx - lo, hi - lo + 1)
    if kind == "reflect":
        n = hi - lo + 1
        p = max(2 * n - 2, 1)            # degenerate n == 1 -> all at lo
        m = torch.remainder(idx - lo, p)
        return lo + torch.where(m >= n, p - m, m)
    return idx.clamp(lo, hi)             # clamp


def out_of_range(idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Mask of coordinates outside ``[lo, hi]`` (the 'constant' fill set)."""
    return (idx < lo) | (idx > hi)


def pad_axis(arr: torch.Tensor, axis: int, lo: int, hi: int, kind: str,
             value: float = 0.0) -> torch.Tensor:
    """Pad one axis of ``arr`` by ``(lo, hi)`` ghost cells per the BC kind,
    as numpy's ``edge``/``wrap``/``reflect``/``constant`` pad modes do, for
    any pad width.  ``reflect`` on a length-1 axis degrades to edge
    replication."""
    if lo == 0 and hi == 0:
        return arr
    n = arr.shape[axis]
    idx = torch.arange(-lo, n + hi, device=arr.device)
    if kind == "constant":
        src = arr.index_select(axis, idx.clamp(0, n - 1))
        shape = [1] * arr.ndim
        shape[axis] = idx.numel()
        mask = out_of_range(idx, 0, n - 1).reshape(shape)
        fill = torch.tensor(value, dtype=arr.dtype, device=arr.device)
        return torch.where(mask, fill, src)
    if kind == "reflect" and n < 2:
        kind = "clamp"
    return arr.index_select(axis, map_index(idx, 0, n - 1, kind))
