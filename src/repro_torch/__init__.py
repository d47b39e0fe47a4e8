"""PyTorch/CUDA port of the combined spatial/temporal blocking stencil system.

The package mirrors ``repro``'s layout: ``core`` (stencils, boundary
conditions, precision policy, block geometry), ``programs`` (multi-stage
stage programs, and the unroll and window arithmetic of the streaming
kernel), ``kernels`` (the oracle, the
super-step loops and the hand-written Hopper kernel) and ``api``
(``StencilProblem`` -> ``plan()`` -> ``StencilPlan``).  It imports ``torch``
and never ``jax``.

    from repro_torch.api import RunConfig, StencilProblem, plan

    p = plan(StencilProblem("diffusion2d", (4096, 4096)),
             RunConfig(backend="hopper", par_time=8, bsize=(256,)))
    out = p.run(grid, iters=1000)
"""
