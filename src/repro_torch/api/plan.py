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
        """Advance ``grid`` by ``iters`` time-steps (program iterations:
        each applies every stage).  ``coeffs`` overrides
        :func:`~repro_torch.core.stencils.default_coeffs` and the stages'
        own overrides by name: a dict for a single-stage problem, a
        sequence of per-stage dicts or ``None`` for a program.  ``aux`` is
        the Hotspot ``power`` grid.  A multi-field program takes and
        returns the ``(n_fields, *shape)`` stack (``problem.state_shape``).
        Inputs go to the plan's device."""
        grid = self._state(grid, self.problem.state_shape, "grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        aux = self._aux(aux, (self.problem.shape,))
        # host-side coefficients: the kernel takes them by value
        coeffs = self.problem.resolve_coeffs(coeffs)
        if iters == 0:
            return grid
        if self.problem.n_stages == 1:
            coeffs = coeffs[0]
        return self._execute(grid, coeffs, iters, aux)

    def run_batch(self, grids, iters: int, coeffs=None, *,
                  aux=None) -> torch.Tensor:
        """Advance a batch ``(B, *shape)`` of grids: one :meth:`run` per
        member, so each result equals the sequential run.  ``aux`` is one
        grid shared by the batch or one per member ``(B, *shape)``."""
        grids = torch.as_tensor(grids, dtype=self.problem.torch_dtype,
                                device=self.device)
        state = self.problem.state_shape
        if grids.ndim != len(state) + 1 or grids.shape[0] < 1:
            raise ValueError(f"run_batch needs grids of shape "
                             f"(B, *{state}), B >= 1; got "
                             f"{tuple(grids.shape)}")
        shape = self.problem.shape
        aux = self._aux(aux, (shape, (grids.shape[0],) + shape))
        per_member = aux is not None and aux.ndim == grids.ndim
        return torch.stack([
            self.run(g, iters, coeffs, aux=aux[b] if per_member else aux)
            for b, g in enumerate(grids)])

    def traffic_report(self, iters: Optional[int] = None) -> dict:
        """Model traffic (paper Eq. 7/8) against the streaming kernel's
        device-memory bytes (``kernels/ops.dma_traffic_bytes``), the
        kernel's shared memory for its rings (``smem_bytes``), and the
        fields with the streams read (``F`` plus aux) and written (``F``).
        For a program it adds the stages and the fusion accounting: the
        fused program's intermediates stay in shared memory (0
        device-memory bytes) where chained single-stage plans would write
        and re-read each of the ``S - 1`` intermediates once per
        iteration."""
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
            "smem_bytes": smem_bytes(geom, self.problem.exec_dag, cb),
            # device-memory streams per super-step: one per field, plus aux
            "fields": list(self.problem.fields),
            "streams_in": st.num_read,
            "streams_out": st.num_write,
        }
        n_stages = self.problem.n_stages
        if n_stages > 1:
            cells = math.prod(self.problem.shape)
            report["stages"] = [
                {"name": s.name, "radius": s.stencil.radius,
                 "flop_pcu": s.stencil.flop_pcu, "bc": s.boundary.token()}
                for s in self.problem.stages]
            report["intermediate_hbm_bytes_per_superstep"] = 0
            report["unfused_intermediate_bytes_per_superstep"] = (
                2 * (n_stages - 1) * cells * cb * geom.par_time)
        if iters is not None:
            n_super = math.ceil(iters / geom.par_time)
            report["n_super"] = n_super
            report["model_bytes_total"] = model * n_super
            report["kernel_dma_bytes_total"] = kernel * n_super
        return report
