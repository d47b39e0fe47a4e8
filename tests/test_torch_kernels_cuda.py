"""The Hopper streaming kernel against its plain version and the port's
oracle, on the card.  Needs an sm_90 device and ``nvcc``; skipped
otherwise.  Run on a card with
``PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m gpu``.
"""
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, StencilProblem, plan
from repro_torch.core import blocking, precision, stencils
from repro_torch.kernels import builder, ops

pytestmark = pytest.mark.gpu

CASES = [  # (name, dims, par_time, bsize): several blocks, a ragged edge
    ("diffusion2d", (40, 300), 4, (64,)),
    ("hotspot2d", (33, 517), 8, (128,)),
    ("diffusion3d", (21, 50, 45), 3, (16, 16)),
    ("hotspot3d", (19, 37, 70), 2, (12, 32)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc not found")
    return torch.device("cuda")


def _inputs(name, dims, device, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, dims).astype(np.float32))
    aux = None
    if stencils.STENCILS[name].has_aux:
        aux = torch.from_numpy(rng.uniform(0, 0.1, dims).astype(np.float32))
        aux = aux.to(device)
    return g.to(device), aux


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_kernel_matches_plain_version(cuda, case):
    name, dims, par_time, bsize = case
    st = stencils.STENCILS[name]
    geom = blocking.BlockGeometry(len(dims), dims, 1, par_time, bsize)
    g, aux = _inputs(name, dims, cuda)
    gp = ops._pad_blocked(g, geom)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom)
    c = ops.pack_coeffs(st, stencils.default_coeffs(st))
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * cs) for n, cs in
                                    zip(geom.bnum, geom.csize))
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        before = builder.LAUNCHES
        builder.superstep_chain(((st, None),), geom, gp, c, steps, aux_p,
                                out=out)
        torch.cuda.synchronize()
        assert builder.LAUNCHES == before + 1
        want = builder.superstep_plain(st, geom, gp, c, steps, aux_p,
                                       torch.full_like(gp, float("nan")))
        assert not out[region].isnan().any()
        assert int((~out.isnan()).sum()) == math.prod(out[region].shape)
        torch.testing.assert_close(out[region], want[region],
                                   **precision.tolerance("float32", steps,
                                                         scale=100))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plan_on_card_matches_oracle(cuda, case):
    name, dims, par_time, bsize = case
    iters = 2 * par_time + 3
    g, aux = _inputs(name, dims, cuda, seed=1)
    before = builder.LAUNCHES
    got = plan(StencilProblem(name, dims),
               RunConfig(backend="hopper", par_time=par_time, bsize=bsize)
               ).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / par_time)
    want = plan(StencilProblem(name, dims),
                RunConfig(backend="reference")).run(g, iters, aux=aux)
    scale = 100 if name.startswith("hotspot") else None
    torch.testing.assert_close(got, want, **precision.tolerance(
        "float32", iters, scale=scale))
