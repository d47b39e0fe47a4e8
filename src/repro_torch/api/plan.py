"""``plan(problem, config) -> StencilPlan`` — the public entry point."""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.api.backends import ExecuteFn, as_program, get_backend
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
    program = as_program(factory(problem, config, geom))
    return StencilPlan(problem=problem, config=config, geometry=geom,
                       _execute=program.execute,
                       _execute_batch=program.execute_batch)


@dataclasses.dataclass
class StencilPlan:
    """A reusable executable for one (problem, config) pair."""
    problem: StencilProblem
    config: RunConfig
    geometry: Optional[BlockGeometry]
    _execute: ExecuteFn = dataclasses.field(repr=False)
    #: the batched entry point (None: ``run_batch`` loops over ``run``)
    _execute_batch: Optional[ExecuteFn] = dataclasses.field(default=None,
                                                            repr=False)

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

    def _aux(self, aux, shapes, message: str) -> Optional[torch.Tensor]:
        """The aux grid, on the plan's device, of one of ``shapes``
        (``message`` otherwise)."""
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
            raise ValueError(message.format(tuple(aux.shape)))
        return aux

    def _payload(self, coeffs):
        """The execute payload: one dict for a single-stage problem, else
        one per stage; host-side, since the kernel takes coefficients by
        value."""
        coeffs = self.problem.resolve_coeffs(coeffs)
        return coeffs[0] if self.problem.n_stages == 1 else coeffs

    def run(self, grid, iters: int, coeffs=None, *, aux=None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> torch.Tensor:
        """Advance ``grid`` by ``iters`` time-steps (program iterations:
        each applies every stage).  ``coeffs`` overrides
        :func:`~repro_torch.core.stencils.default_coeffs` and the stages'
        own overrides by name: a dict for a single-stage problem, a
        sequence of per-stage dicts or ``None`` for a program.  ``aux`` is
        the Hotspot ``power`` grid.  A multi-field program takes and
        returns the ``(n_fields, *shape)`` stack (``problem.state_shape``).
        Inputs go to the plan's device.

        ``checkpoint_every`` with ``checkpoint_dir`` makes the run
        restartable (:func:`repro_torch.resilience.run_checkpointed`): the
        state is saved atomically every ``checkpoint_every`` iterations,
        rounded up to a super-step multiple, and a run that calls ``run``
        again with the same directory resumes from the last complete save;
        the final grid equals an uninterrupted run's bit for bit."""
        if (checkpoint_every is None) != (checkpoint_dir is None):
            raise ValueError("checkpoint_every and checkpoint_dir go "
                             "together — pass both or neither")
        if checkpoint_dir is not None:
            from repro_torch.resilience.checkpoint_run import \
                run_checkpointed
            return run_checkpointed(
                self, grid, iters, coeffs, aux=aux,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir).grid
        grid = self._state(grid, self.problem.state_shape, "grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        shape = self.problem.shape
        aux = self._aux(aux, (shape,), f"aux shape {{}} != problem shape "
                                       f"{shape}")
        coeffs = self._payload(coeffs)
        if iters == 0:
            return grid
        return self._execute(grid, coeffs, iters, aux)

    def run_batch(self, grids, iters: int, coeffs=None, *,
                  aux=None) -> torch.Tensor:
        """Advance a batch ``(B, *state_shape)`` of grids by ``iters``
        time-steps, each member as :meth:`run` would and equal to it bit for
        bit.  On ``hopper`` the batch is padded once and each super-step is
        one launch for all ``B`` members (the members run along the
        kernel's grid), so a run takes ``ceil(iters/par_time)`` launches
        whatever ``B``; a backend without a batched entry point loops over
        the members.  ``aux`` (Hotspot ``power``) is one grid of ``shape``
        shared by the batch or one per member, ``(B, *shape)``.  Shapes and
        aux are validated before anything runs."""
        grids = torch.as_tensor(grids, dtype=self.problem.torch_dtype,
                                device=self.device)
        state = self.problem.state_shape
        if grids.ndim != len(state) + 1 or tuple(grids.shape[1:]) != state:
            raise ValueError(f"run_batch needs grids of shape (B, *{state}); "
                             f"got {tuple(grids.shape)}")
        if grids.shape[0] < 1:
            raise ValueError("run_batch needs a batch of at least 1 grid")
        iters = int(iters)
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        shape = self.problem.shape
        batched = (grids.shape[0],) + shape
        aux = self._aux(aux, (shape, batched),
                        f"aux shape {{}} must be {shape} (shared) or "
                        f"{batched} (per-batch)")
        coeffs = self._payload(coeffs)
        if iters == 0:
            return grids
        if self._execute_batch is None:
            per_member = aux is not None and aux.ndim > self.problem.ndim
            return torch.stack([
                self._execute(g.contiguous(), coeffs, iters,
                              aux[b] if per_member else aux)
                for b, g in enumerate(grids)])
        return self._execute_batch(grids, coeffs, iters, aux)

    def prewarm(self, batch_sizes=(1,), *, iters: int = 1, coeffs=None,
                single: bool = True) -> dict:
        """Load the plan's kernels and warm them before traffic arrives:
        one :meth:`run` of a zero state (``single``) and one
        :meth:`run_batch` of zeros per size in ``batch_sizes``, each
        ``iters`` steps (1: one super-step) and synchronized.  The first
        call on a card builds and loads the kernel library (compiled at
        first use; ``kernels/_build.py``).  An aux-taking stencil warms the
        per-member aux mode, the one the serving path uses.  Returns
        ``{"single": seconds, B: seconds, ...}`` per warmed entry."""
        if int(iters) < 1:
            raise ValueError(f"prewarm iters must be >= 1, got {iters}")
        sizes = sorted({int(b) for b in batch_sizes})
        if sizes and sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {sizes[0]}")
        prob, dev = self.problem, self.device
        zeros = torch.zeros(prob.state_shape, dtype=prob.torch_dtype,
                            device=dev)
        aux = (torch.zeros(prob.shape, dtype=prob.torch_dtype, device=dev)
               if prob.needs_aux else None)

        def timed(fn) -> float:
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        timings: dict = {}
        if single:
            timings["single"] = timed(
                lambda: self.run(zeros, iters, coeffs, aux=aux))
        for b in sizes:
            aux_b = None if aux is None else aux.expand((b,) + prob.shape)
            timings[b] = timed(lambda: self.run_batch(
                zeros.expand((b,) + prob.state_shape), iters, coeffs,
                aux=aux_b))
        return timings

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
