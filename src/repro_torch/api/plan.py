"""``plan(problem, config) -> StencilPlan`` — the public entry point."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.api.backends import ExecuteFn, get_backend
from repro_torch.api.config import RunConfig
from repro_torch.api.problem import StencilProblem
from repro_torch.core.blocking import (BlockGeometry, extended_geometry,
                                       smem_bytes, superstep_traffic_bytes)


def plan(problem: StencilProblem,
         config: Optional[RunConfig] = None) -> "StencilPlan":
    """Pair ``problem`` with ``config`` into a reusable ``StencilPlan``.
    Raises if the config's device is CUDA and no card is present."""
    if config is None:
        config = RunConfig()
    factory = get_backend(config.backend)
    if config.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("RunConfig(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    bsize = config.normalized_bsize(problem.ndim)
    geom = None
    if config.par_time is not None and bsize is not None:
        geom = BlockGeometry(problem.ndim, problem.shape,
                             problem.stencil.radius, config.par_time, bsize,
                             config.par_vec)
    return StencilPlan(problem=problem, config=config, geometry=geom,
                       _execute=factory(problem, config, geom))


@dataclasses.dataclass
class StencilPlan:
    """A reusable executable for one (problem, config) pair."""
    problem: StencilProblem
    config: RunConfig
    geometry: Optional[BlockGeometry]
    _execute: ExecuteFn = dataclasses.field(repr=False)

    @property
    def device(self) -> torch.device:
        return self.config.device

    def _state(self, x, shape, what: str) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=self.problem.torch_dtype,
                            device=self.device).contiguous()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        return t

    def _aux(self, aux, shapes) -> Optional[torch.Tensor]:
        if not self.problem.needs_aux:
            if aux is not None:
                raise ValueError(f"{self.problem.stencil.name} takes no aux "
                                 "grid")
            return None
        if aux is None:
            raise ValueError(f"{self.problem.stencil.name} needs an aux "
                             "(power) grid")
        aux = torch.as_tensor(aux, dtype=self.problem.torch_dtype,
                              device=self.device).contiguous()
        if tuple(aux.shape) not in shapes:
            raise ValueError(f"aux shape {tuple(aux.shape)} must be one of "
                             f"{list(shapes)}")
        return aux

    def run(self, grid, iters: int, coeffs=None, *,
            aux=None) -> torch.Tensor:
        """Advance ``grid`` by ``iters`` time-steps.  ``coeffs`` overrides
        :func:`~repro_torch.core.stencils.default_coeffs` by name; ``aux``
        is the Hotspot ``power`` grid.  Inputs go to the plan's device."""
        grid = self._state(grid, self.problem.shape, "grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        aux = self._aux(aux, (self.problem.shape,))
        # host-side coefficients: the kernel takes them by value
        coeffs = self.problem.resolve_coeffs(coeffs)
        if iters == 0:
            return grid
        return self._execute(grid, coeffs, iters, aux)

    def run_batch(self, grids, iters: int, coeffs=None, *,
                  aux=None) -> torch.Tensor:
        """Advance a batch ``(B, *shape)`` of grids: one :meth:`run` per
        member, so each result equals the sequential run.  ``aux`` is one
        grid shared by the batch or one per member ``(B, *shape)``."""
        grids = torch.as_tensor(grids, dtype=self.problem.torch_dtype,
                                device=self.device)
        if grids.ndim != self.problem.ndim + 1 or grids.shape[0] < 1:
            raise ValueError(f"run_batch needs grids of shape "
                             f"(B, *{self.problem.shape}), B >= 1; got "
                             f"{tuple(grids.shape)}")
        shape = self.problem.shape
        aux = self._aux(aux, (shape, (grids.shape[0],) + shape))
        per_member = aux is not None and aux.ndim == grids.ndim
        return torch.stack([
            self.run(g, iters, coeffs, aux=aux[b] if per_member else aux)
            for b, g in enumerate(grids)])

    def traffic_report(self, iters: Optional[int] = None) -> dict:
        """Model traffic (paper Eq. 7/8) against the streaming kernel's
        device-memory bytes (``kernels/ops.dma_traffic_bytes``)."""
        from repro_torch.kernels.ops import dma_traffic_bytes
        geom = self.geometry
        if geom is None:
            raise ValueError("traffic_report() needs a block geometry: "
                             "pin par_time and bsize")
        st = self.problem.stencil
        cb = self.problem.cell_bytes
        bc = self.problem.structural_bc
        model = superstep_traffic_bytes(extended_geometry(geom, bc),
                                        st.num_read, st.num_write, cb)
        kernel = dma_traffic_bytes(st, geom, cb, bc=bc)
        report = {
            "model_bytes_per_superstep": model,
            "kernel_dma_bytes_per_superstep": kernel,
            "traffic_accuracy": model / kernel,
            "redundancy": geom.redundancy,
            "par_vec": geom.par_vec,
            "smem_bytes": smem_bytes(geom, st.has_aux, cb),
        }
        if iters is not None:
            n_super = math.ceil(iters / geom.par_time)
            report["n_super"] = n_super
            report["model_bytes_total"] = model * n_super
            report["kernel_dma_bytes_total"] = kernel * n_super
        return report
