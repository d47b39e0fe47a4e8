"""``repro_torch.api`` end to end on the CPU against the reference package's
``plan()``: the ``hopper`` backend (its plain version here), the port's
``reference`` backend, ``run_batch``, and the plan-time refusals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import api as japi
from repro_torch.api import RunConfig, StencilProblem, plan
from repro_torch.convert import state_from_reference
from repro_torch.core import stencils


def _runs(name, dims, iters, par_time, bsize, ref_backend):
    """(port hopper on cpu, reference package's ``ref_backend``)."""
    g, aux = conf.data(name, dims)
    jc, tc = conf.coeffs(name)
    jp = japi.plan(japi.StencilProblem(name, dims),
                   japi.RunConfig(backend=ref_backend, par_time=par_time,
                                  bsize=bsize))
    want = jp.run(jnp.asarray(g), iters, jc,
                  aux=None if aux is None else jnp.asarray(aux))
    p = plan(StencilProblem(name, dims),
             RunConfig(backend="hopper", par_time=par_time, bsize=bsize,
                       device="cpu"))
    got = p.run(state_from_reference(g), iters, tc,
                aux=None if aux is None else state_from_reference(aux))
    return got, want


@pytest.mark.parametrize("name,dims,iters,par_time,bsize", [
    ("diffusion2d", (29, 61), 7, 4, 40),
    ("hotspot2d", (29, 61), 7, 4, 40),
    ("diffusion3d", (9, 22, 30), 5, 4, 20),
    ("hotspot3d", (9, 22, 30), 5, 4, 20),
])
def test_hopper_cpu_matches_pallas_interpret(name, dims, iters, par_time,
                                             bsize):
    """Several blocks per blocked axis and a PE-forwarding remainder."""
    got, want = _runs(name, dims, iters, par_time, bsize,
                      "pallas_interpret")
    assert got.shape == dims and got.dtype == torch.float32
    conf.assert_close(got, want, conf.tol(name, iters))


@pytest.mark.parametrize("dims,iters,par_time,bsize", [
    ((17, 40), 1, 1, 24),
    ((33, 70), 4, 4, 32),
    ((12, 130), 6, 2, 128),
    ((5, 33), 3, 2, 16),      # tiny stream extent
    ((7, 19, 23), 1, 1, 12),
    ((11, 25, 17), 4, 2, 12),
    ((4, 15, 15), 2, 2, 10),
])
@pytest.mark.parametrize("kind", ["diffusion", "hotspot"])
def test_hopper_cpu_matches_reference_backend(kind, dims, iters, par_time,
                                              bsize):
    name = f"{kind}{len(dims)}d"
    got, want = _runs(name, dims, iters, par_time, bsize, "reference")
    conf.assert_close(got, want, conf.tol(name, iters))


@pytest.mark.parametrize("name", ["diffusion2d", "hotspot3d"])
def test_port_reference_backend_matches_hopper(name):
    dims = (13, 30) if name.endswith("2d") else (7, 16, 18)
    g, aux = conf.data(name, dims)
    outs = [plan(StencilProblem(name, dims),
                 RunConfig(backend=b, par_time=3, bsize=12, device="cpu"))
            .run(g, 8, aux=aux) for b in ("reference", "hopper")]
    conf.assert_close(outs[1], outs[0], conf.tol(name, 8))


@pytest.mark.parametrize("name", ["hotspot2d", "diffusion3d"])
@pytest.mark.parametrize("shared_aux", [True, False])
def test_run_batch_equals_sequential_runs(name, shared_aux):
    dims = (11, 40) if name.endswith("2d") else (6, 14, 15)
    p = plan(StencilProblem(name, dims),
             RunConfig(backend="hopper", par_time=3, bsize=(16,) * (
                 len(dims) - 1), device="cpu"))
    rng = np.random.default_rng(5)
    grids = rng.uniform(0.5, 2.0, (3,) + dims).astype(np.float32)
    aux = None
    if p.problem.needs_aux:
        aux = rng.uniform(0, 0.1, dims if shared_aux else (3,) + dims
                          ).astype(np.float32)
    got = p.run_batch(grids, 7, aux=aux)
    for b in range(3):
        ab = aux if aux is None or shared_aux else aux[b]
        assert torch.equal(got[b], p.run(grids[b], 7, aux=ab))


def test_traffic_report_matches_reference():
    for name, dims, bsize in [("hotspot2d", (64, 300), 64),
                              ("diffusion3d", (20, 40, 50), 16)]:
        cfg = dict(par_time=4, bsize=bsize)
        mine = plan(StencilProblem(name, dims),
                    RunConfig(backend="hopper", device="cpu", **cfg))
        ref = japi.plan(japi.StencilProblem(name, dims),
                        japi.RunConfig(backend="pallas_interpret", **cfg))
        a, b = mine.traffic_report(10), ref.traffic_report(10)
        for k in ("model_bytes_per_superstep",
                  "kernel_dma_bytes_per_superstep", "traffic_accuracy",
                  "redundancy", "n_super", "kernel_dma_bytes_total"):
            assert a[k] == b[k], k
        assert a["smem_bytes"] == 4 * 3 * 4 * np.prod(mine.geometry.bsize)


def test_zero_iters_and_input_validation():
    p = plan(StencilProblem("hotspot2d", (8, 20)),
             RunConfig(backend="hopper", par_time=2, bsize=10,
                       device="cpu"))
    g, aux = conf.data("hotspot2d", (8, 20))
    assert torch.equal(p.run(g, 0, aux=aux), torch.from_numpy(g))
    with pytest.raises(ValueError, match="aux"):
        p.run(g, 1)
    with pytest.raises(ValueError, match="shape"):
        p.run(g[1:], 1, aux=aux)
    with pytest.raises(ValueError, match="iters"):
        p.run(g, -1, aux=aux)
    with pytest.raises(ValueError, match="unknown coefficients"):
        p.run(g, 1, {"zz": 1.0}, aux=aux)


def _hopper(problem, **cfg):
    cfg.setdefault("par_time", 2)
    cfg.setdefault("bsize", 16)
    return plan(problem, RunConfig(backend="hopper", device="cpu", **cfg))


def test_hopper_refusals_name_the_roadmap_item():
    with pytest.raises(ValueError, match="B1e"):
        _hopper(StencilProblem("diffusion2d", (8, 32), dtype="bfloat16"))
    with pytest.raises(ValueError, match="B1c"):
        _hopper(StencilProblem("diffusion2d", (8, 32), boundary="periodic"))
    with pytest.raises(ValueError, match="B1c"):
        _hopper(StencilProblem("hotspot3d", (8, 20, 20),
                               boundary=("clamp", "clamp", "reflect")))
    with pytest.raises(ValueError, match="B1d"):
        _hopper(StencilProblem("diffusion2d", (8, 32)), par_vec=2)
    with pytest.raises(ValueError, match="B1d"):
        _hopper(StencilProblem("star1d_r1", (64,)), bsize=())
    with pytest.raises(ValueError, match="B1i"):
        _hopper(StencilProblem(stencils.make_star(2, 1), (8, 32)))
    with pytest.raises(ValueError, match="A11"):
        plan(StencilProblem("diffusion2d", (8, 32)),
             RunConfig(backend="hopper", device="cpu"))
    with pytest.raises(ValueError, match="threads"):
        _hopper(StencilProblem("diffusion3d", (8, 64, 64)), bsize=(40, 40))
    with pytest.raises(ValueError, match="shared memory"):
        _hopper(StencilProblem("diffusion2d", (8, 9000)), par_time=40,
                bsize=1000)
    with pytest.raises(NotImplementedError, match="A12"):
        StencilProblem(["diffusion2d", "diffusion2d"], (8, 32))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(StencilProblem("diffusion2d", (8, 32)),
             RunConfig(backend="hopper", par_time=2, bsize=16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan(StencilProblem("diffusion2d", (8, 32)),
             RunConfig(backend="reference"))


def test_reference_backend_runs_what_hopper_refuses():
    """bf16 and non-clamp problems run on the port's oracle."""
    g, _ = conf.data("diffusion2d", (8, 32))
    for prob in (StencilProblem("diffusion2d", (8, 32), dtype="bf16"),
                 StencilProblem("diffusion2d", (8, 32),
                                boundary="constant:1.5")):
        out = plan(prob, RunConfig(backend="reference", device="cpu")).run(
            g, 3)
        assert out.dtype == prob.torch_dtype and out.isfinite().all()
