"""Public API: ``StencilProblem`` -> ``plan()`` -> ``StencilPlan``.

    from repro_torch.api import RunConfig, StencilProblem, plan

    p = plan(StencilProblem("hotspot3d", (448, 448, 448)),
             RunConfig(backend="hopper", par_time=4, bsize=(32, 32)))
    out = p.run(grid, iters=100, aux=power)

A program fuses its stages into one super-step:

    from repro_torch.api import StencilStage
    from repro_torch.core.stencils import make_star

    prog = [StencilStage(make_star(2, 1), coeffs={"c0": 0.7}),
            StencilStage("diffusion2d")]
    p = plan(StencilProblem(prog, (4096, 4096)),
             RunConfig(backend="hopper", par_time=4, bsize=256))

Backends: ``hopper`` (the streaming CUDA kernel; its plain version when
``RunConfig(device="cpu")``) and ``reference`` (the unblocked oracle).
"""
from repro_torch.api.backends import (get_backend, list_backends,
                                      register_backend)
from repro_torch.api.config import RunConfig
from repro_torch.api.plan import StencilPlan, plan
from repro_torch.api.problem import StencilProblem
from repro_torch.core.boundary import BoundaryCondition
from repro_torch.programs import StencilProgram, StencilStage

__all__ = [
    "BoundaryCondition", "RunConfig", "StencilPlan", "StencilProblem",
    "StencilProgram", "StencilStage", "get_backend", "list_backends", "plan",
    "register_backend",
]
