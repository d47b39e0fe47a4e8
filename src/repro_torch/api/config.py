"""Execution configuration — how to run a :class:`StencilProblem`."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Backend, pinned schedule and device of one plan.

    ``par_time`` and ``bsize`` are pinned: the performance model and
    autotuning are not ported yet (ROADMAP A11).  ``device`` is where the
    grids live and the backend runs: ``"cuda"`` (the default) launches the
    kernels, ``"cpu"`` runs their plain versions."""
    backend: str = "hopper"
    par_time: Optional[int] = None
    bsize: Optional[Union[int, Tuple[int, ...]]] = None
    par_vec: int = 1
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.par_time is not None and self.par_time < 1:
            raise ValueError(f"par_time must be >= 1, got {self.par_time}")
        if self.par_vec < 1:
            raise ValueError(f"par_vec must be >= 1, got {self.par_vec}")
        if self.bsize is not None and not isinstance(self.bsize, int):
            object.__setattr__(self, "bsize",
                               tuple(int(b) for b in self.bsize))
        object.__setattr__(self, "device", torch.device(self.device))

    def normalized_bsize(self, ndim: int) -> Optional[Tuple[int, ...]]:
        """bsize as a per-blocked-dim tuple (``ndim - 1`` entries)."""
        if self.bsize is None:
            return None
        if isinstance(self.bsize, int):
            return (self.bsize,) * (ndim - 1)
        if len(self.bsize) != ndim - 1:
            raise ValueError(f"bsize {self.bsize} has {len(self.bsize)} "
                             f"entries; a {ndim}D grid blocks {ndim - 1} dims")
        return self.bsize
