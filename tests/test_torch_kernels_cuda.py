"""The Hopper streaming kernel against its plain version and the port's
oracle, on the card: the four Table-2 stencils, linear stage chains (tap
tables, mixed radii, radius-0 stages, aux), stage DAGs (field streams,
fan-in, state nodes), periodic boundaries, V-row slabs (``par_vec > 1``)
and 1D grids on all three bodies, and bfloat16 storage and the reflect and
constant boundaries (mixed per axis and per chain stage) on all three
bodies, DAGs whose stages differ in boundary (the mixed-boundary body),
block planes over 1024 cells (the wide form), tables past the kernel
parameter's capacities (the large-table route), stencils with a custom
``apply`` (device functions generated per program), and the stream cut
into more segments than the launcher would (each CTA of a block
streaming its own after a warm-up) in every form, DAGs in the DAG bodies'
one-barrier form and in the per-entry-barrier forms.  Needs an
sm_90 device and ``nvcc``; skipped otherwise.  Run on a card with
``PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -m gpu``.
"""
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
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
        want = builder.superstep_plain(((st, None),), geom, gp, c, steps,
                                       aux_p,
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


def _advect(nd):
    return StencilStage(stencils.make_star(nd, 1),
                        coeffs={"c0": 0.7, "c_0_-1": 0.1, "c_0_1": 0.0,
                                f"c_{nd - 1}_-1": 0.2, f"c_{nd - 1}_1": 0.0})


def _damp(nd):
    return StencilStage(stencils.make_star(nd, 0), coeffs={"c0": 0.995})


PROGRAMS = [  # (id, stages, dims, par_time, bsize)
    ("advect_diffuse2d", lambda: [_advect(2), StencilStage("diffusion2d")],
     (40, 300), 3, (64,)),
    ("diffuse_damp2d", lambda: [StencilStage("diffusion2d"), _damp(2)],
     (33, 517), 4, (128,)),
    ("star_diffuse3d", lambda: [StencilStage(stencils.make_star(3, 1)),
                                StencilStage("diffusion3d")],
     (21, 50, 45), 2, (16, 16)),
    ("diffuse3_2d", lambda: [StencilStage("diffusion2d")] * 3, (25, 200), 2,
     (64,)),
    ("hotspot_damp2d", lambda: [StencilStage("hotspot2d"), _damp(2)],
     (19, 200), 3, (64,)),
    ("star_r2_diffuse2d", lambda: [StencilStage(stencils.make_star(2, 2)),
                                   StencilStage("diffusion2d")],
     (30, 200), 2, (64,)),
    ("box2d_diffuse", lambda: [StencilStage(stencils.make_box(2, 1)),
                               StencilStage("diffusion2d")],
     (26, 150), 2, (48,)),
    ("box3d_r1", lambda: [StencilStage(stencils.make_box(3, 1),
                                       coeffs={"b_0_0_0": 0.3})],
     (14, 30, 33), 2, (16, 16)),
    # 12 entries on a 12-cell block plane: radius-0 stages add entries but
    # no halo
    ("damp2_diffuse2d", lambda: [StencilStage("diffusion2d"), _damp(2),
                                 _damp(2)], (20, 60), 4, (12,)),
    # the main-path body: 80 entries, more than the chain body's table
    ("diffusion2d_t80", lambda: [StencilStage("diffusion2d")], (10, 400),
     80, (170,)),
]


def _program_inputs(problem, device, seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, problem.shape)
                         .astype(np.float32)).to(device)
    aux = None
    if problem.needs_aux:
        aux = torch.from_numpy(rng.uniform(0, 0.1, problem.shape)
                               .astype(np.float32)).to(device)
    return g, aux


@pytest.mark.parametrize("case", PROGRAMS, ids=lambda c: c[0])
def test_chain_kernel_equals_plain_version(cuda, case):
    """One super-step of the chain kernel, bit for bit against its plain
    version on the card, with and without PE forwarding."""
    _, stages, dims, par_time, bsize = case
    problem = StencilProblem(stages(), dims)
    p = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize))
    geom, ex = p.geometry, problem.exec_stages
    g, aux = _program_inputs(problem, cuda, seed=2)
    gp = ops._pad_blocked(g, geom)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom)
    c = ops.pack_program_coeffs(ex, problem.resolve_coeffs())
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * cs) for n, cs in
                                    zip(geom.bnum, geom.csize))
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        before = builder.LAUNCHES
        builder.superstep_chain(ex, geom, gp, c, steps, aux_p, out=out)
        torch.cuda.synchronize()
        assert builder.LAUNCHES == before + 1
        want = builder.superstep_plain(ex, geom, gp, c, steps, aux_p,
                                       torch.full_like(gp, float("nan")))
        assert not out[region].isnan().any()
        assert int((~out.isnan()).sum()) == math.prod(out[region].shape)
        assert torch.equal(out[region], want[region])


@pytest.mark.parametrize("case", PROGRAMS, ids=lambda c: c[0])
def test_program_plan_on_card_matches_oracle(cuda, case):
    _, stages, dims, par_time, bsize = case
    problem = StencilProblem(stages(), dims)
    iters = 2 * par_time + 3
    g, aux = _program_inputs(problem, cuda, seed=3)
    before = builder.LAUNCHES
    got = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                  bsize=bsize)).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / par_time)
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    scale = 100 if problem.needs_aux else None
    torch.testing.assert_close(got, want, **precision.tolerance(
        "float32", iters, stages=problem.n_stages, scale=scale))


# --- stage DAGs and periodic boundaries ---------------------------------------

def _wave(nd):
    lap = {"c0": -2.0 * nd}
    lap.update({f"c_{a}_{d}": 1.0 for a in range(nd) for d in (-1, 1)})
    return StencilProgram(
        (StencilStage(stencils.make_star(nd, 1), coeffs=lap, name="lapu",
                      inputs=("u",)),
         StencilStage(stencils.make_combine(nd, 3), name="unext",
                      inputs=("u", "u_prev", "lapu"),
                      coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.16})),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond():
    s = stencils.make_star(2, 1)
    return StencilProgram(
        (StencilStage(s, name="a", inputs=("u",)),
         StencilStage(s, name="b", inputs=("u",),
                      coeffs={"c0": 0.5, "c_0_1": 0.2}),
         StencilStage(stencils.make_combine(2, 2), name="m",
                      inputs=("a", "b"), coeffs={"w0": 0.6, "w1": 0.4})))


def _hotspot_dag():
    return StencilProgram(
        (StencilStage("hotspot2d", name="h", inputs=("u",)),
         StencilStage(stencils.make_combine(2, 3), name="m",
                      inputs=("h", "u", "v"),
                      coeffs={"w0": 0.5, "w1": 0.3, "w2": 0.2})),
        fields=("u", "v"), updates={"u": "m", "v": "u"})


def _fanin4():
    """Four inputs to one combine, radii 0 to 2, a field carried
    unchanged."""
    st = stencils
    return StencilProgram(
        (StencilStage(st.make_star(2, 2), name="s0", inputs=("f1",)),
         StencilStage(st.make_star(2, 0), name="s1", inputs=("s0",)),
         StencilStage(st.make_box(2, 1), name="s2", inputs=("f0",)),
         StencilStage(st.make_combine(2, 4), name="out",
                      inputs=("s1", "s2", "f0", "f1"))),
        fields=("f0", "f1", "f2"), updates={"f0": "out", "f1": "f0"})


DAGS = [  # (id, program, dims, boundary, par_time, bsize)
    ("wave2d_periodic", lambda: _wave(2), (37, 300), "periodic", 4, (64,)),
    ("wave2d_clamp", lambda: _wave(2), (30, 211), "clamp", 3, (48,)),
    ("diamond_periodic_clamp", _diamond, (33, 150), ("periodic", "clamp"),
     2, (40,)),
    ("hotspot_dag", _hotspot_dag, (25, 170), ("clamp", "periodic"), 3,
     (32,)),
    ("fanin4", _fanin4, (29, 130), "periodic", 2, (32,)),
    ("wave3d_periodic", lambda: _wave(3), (17, 40, 35), "periodic", 2,
     (16, 16)),
    ("wave3d_clamp", lambda: _wave(3), (21, 30, 45), "clamp", 2, (16, 16)),
]

PERIODIC = [  # (id, stages, dims, boundary, par_time, bsize)
    ("diffusion2d", lambda: [StencilStage("diffusion2d")], (40, 300),
     "periodic", 4, (64,)),
    ("hotspot3d", lambda: [StencilStage("hotspot3d")], (19, 37, 70),
     ("clamp", "periodic", "periodic"), 2, (12, 32)),
    ("chain_clamp_periodic", lambda: [StencilStage(stencils.make_star(2, 1)),
                                      StencilStage("diffusion2d")],
     (33, 200), ("clamp", "periodic"), 2, (64,)),
    ("chain3d_periodic", lambda: [StencilStage(stencils.make_star(3, 1)),
                                  StencilStage("diffusion3d")],
     (21, 50, 45), ("periodic", "clamp", "periodic"), 2, (16, 16)),
]


def _state(problem, device, seed):
    """State and aux from ``seed``, in the problem's storage dtype."""
    rng = np.random.default_rng(seed)
    dt = problem.torch_dtype
    g = torch.from_numpy(rng.uniform(0.5, 2.0, problem.state_shape)
                         .astype(np.float32)).to(device, dt)
    aux = None
    if problem.needs_aux:
        aux = torch.from_numpy(rng.uniform(0, 0.1, problem.shape)
                               .astype(np.float32)).to(device, dt)
    return g, aux


def _superstep_vs_plain(problem, geom, g, aux):
    """One super-step through the kernel, bit for bit against the plain
    version on the card, with and without forwarding; the output starts as
    NaN so that a cell the kernel misses or writes wrongly shows."""
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    h = geom.size_halo
    # rows past the real stream extent (the slab pad) are never written
    region = (Ellipsis, slice(0, builder._stream_dom(geom, bc0))) + tuple(
        slice(h, h + n * cs) for n, cs in zip(geom.bnum, geom.csize))
    for steps in (geom.par_time, geom.par_time - 1):
        out = torch.full_like(gp, float("nan"))
        before = builder.LAUNCHES
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out)
        torch.cuda.synchronize()
        assert builder.LAUNCHES == before + 1
        plain = torch.full_like(gp, float("nan"))
        if problem.is_dag:
            builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p,
                                        plain)
        else:
            builder.superstep_plain(problem.exec_stages, geom, gp, c, steps,
                                    aux_p, plain)
        assert not out[region].isnan().any()
        assert int((~out.isnan()).sum()) == math.prod(out[region].shape)
        assert torch.equal(out[region], plain[region])
    return gp, aux_p, dag, c, region, out


@pytest.mark.parametrize("case", DAGS, ids=lambda c: c[0])
def test_dag_kernel_equals_plain_version(cuda, case):
    _, program, dims, bc, par_time, bsize = case
    problem = StencilProblem(program(), dims, boundary=bc)
    assert problem.is_dag
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize)).geometry
    g, aux = _state(problem, cuda, seed=4)
    _superstep_vs_plain(problem, geom, g, aux)


@pytest.mark.parametrize("case", PERIODIC, ids=lambda c: c[0])
def test_periodic_kernel_equals_plain_version(cuda, case):
    """Periodic and mixed boundaries on the main-path and chain bodies."""
    _, stages, dims, bc, par_time, bsize = case
    problem = StencilProblem(stages(), dims, boundary=bc)
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize)).geometry
    g, aux = _state(problem, cuda, seed=5)
    _superstep_vs_plain(problem, geom, g, aux)


@pytest.mark.parametrize("case", DAGS + PERIODIC, ids=lambda c: c[0])
def test_dag_and_periodic_plan_on_card_matches_reference(cuda, case):
    _, program, dims, bc, par_time, bsize = case
    problem = StencilProblem(program(), dims, boundary=bc)
    iters = 2 * par_time + 1
    g, aux = _state(problem, cuda, seed=6)
    before = builder.LAUNCHES
    got = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                  bsize=bsize)).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / par_time)
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    scale = 100 if problem.needs_aux else None
    torch.testing.assert_close(got, want, **precision.tolerance(
        "float32", iters, stages=problem.n_stages, scale=scale))


# --- V-row slabs (par_vec > 1) and 1D grids ----------------------------------

def _star(name):
    return lambda: [StencilStage(name)]


PAR_VEC = [  # (id, program, dims, boundary, par_time, bsize, par_vec): stream
    # extents that V does not divide, the three bodies, 1D on two of them
    ("diffusion2d_v4", _star("diffusion2d"), (37, 300), "clamp", 4, (64,), 4),
    ("hotspot2d_v8", _star("hotspot2d"), (33, 517), "clamp", 4, (128,), 8),
    ("diffusion2d_periodic_v16", _star("diffusion2d"), (40, 300), "periodic",
     4, (64,), 16),
    ("diffusion3d_v2", _star("diffusion3d"), (21, 50, 45), "clamp", 3,
     (16, 16), 2),
    ("hotspot3d_v4", _star("hotspot3d"), (19, 37, 70),
     ("clamp", "periodic", "periodic"), 2, (12, 32), 4),
    ("chain_r2_v4", lambda: [StencilStage(stencils.make_star(2, 2)),
                             StencilStage("diffusion2d")], (30, 200),
     "clamp", 2, (64,), 4),
    ("chain3d_periodic_v2", lambda: [StencilStage(stencils.make_star(3, 1)),
                                     StencilStage("diffusion3d")],
     (21, 50, 45), ("periodic", "clamp", "periodic"), 2, (16, 16), 2),
    # 12 entries on a 12-cell plane: the CTA is rounded up to 32 threads
    ("damp2_chain_v8", lambda: [StencilStage("diffusion2d"), _damp(2),
                                _damp(2)], (20, 60), "clamp", 4, (12,), 8),
    # a 300-cell plane: 2 rows of a slab at once, several rows per thread
    ("advect_diffuse2d_rows_v4", lambda: [_advect(2),
                                          StencilStage("diffusion2d")],
     (37, 700), "clamp", 2, (300,), 4),
    ("wave2d_periodic_v4", lambda: _wave(2), (37, 300), "periodic", 4, (64,),
     4),
    ("wave2d_rows_v8", lambda: _wave(2), (37, 700), "periodic", 2, (300,),
     8),
    ("hotspot_dag_v4", _hotspot_dag, (25, 170), ("clamp", "periodic"), 3,
     (32,), 4),
    ("fanin4_v2", _fanin4, (29, 130), "periodic", 2, (32,), 2),
    ("wave3d_v4", lambda: _wave(3), (17, 40, 35), "clamp", 2, (16, 16), 4),
    ("star1d_r1_v1", _star("star1d_r1"), (1001,), "clamp", 4, (), 1),
    ("star1d_r2_periodic_v16", _star("star1d_r2"), (1001,), "periodic", 4,
     (), 16),
    ("wave1d_v4", lambda: _wave(1), (999,), "clamp", 3, (), 4),
]


def _par_vec_case(case):
    _, program, dims, bc, par_time, bsize, V = case
    problem = StencilProblem(program(), dims, boundary=bc)
    cfg = dict(backend="hopper", par_time=par_time, bsize=bsize)
    return problem, cfg, V


@pytest.mark.parametrize("case", PAR_VEC, ids=lambda c: c[0])
def test_par_vec_kernel_equals_plain_version(cuda, case):
    """One super-step bit for bit against the plain version; then the
    slab-pad rows of the input set to NaN, which must change nothing: no
    row past the real stream extent is ever tapped."""
    problem, cfg, V = _par_vec_case(case)
    geom = plan(problem, RunConfig(par_vec=V, **cfg)).geometry
    g, aux = _state(problem, cuda, seed=7)
    gp, aux_p, dag, c, region, out = _superstep_vs_plain(problem, geom, g,
                                                         aux)
    dom = builder._stream_dom(geom, problem.structural_bc)
    if gp.shape[-geom.ndim] > dom:
        poisoned = gp.clone()
        poisoned[(Ellipsis, slice(dom, None)) + (slice(None),) * (
            geom.ndim - 1)] = float("nan")
        again = torch.full_like(gp, float("nan"))
        builder.superstep_dag(dag, geom, poisoned, c, geom.par_time - 1,
                              aux_p, out=again)
        assert torch.equal(again[region], out[region])


@pytest.mark.parametrize("case", PAR_VEC, ids=lambda c: c[0])
def test_par_vec_plan_equals_v1_plan(cuda, case):
    """The plan at V launches ``ceil(iters/T)`` times and equals the plan at
    V = 1 bit for bit, which stays within tolerance of the reference."""
    problem, cfg, V = _par_vec_case(case)
    iters = 2 * cfg["par_time"] + 1
    g, aux = _state(problem, cuda, seed=8)
    before = builder.LAUNCHES
    got = plan(problem, RunConfig(par_vec=V, **cfg)).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / cfg["par_time"])
    v1 = plan(problem, RunConfig(par_vec=1, **cfg)).run(g, iters, aux=aux)
    assert torch.equal(got, v1)
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    scale = 100 if problem.needs_aux else None
    torch.testing.assert_close(v1, want, **precision.tolerance(
        "float32", iters, stages=problem.n_stages, scale=scale))


# --- bfloat16 storage and the reflect and constant boundaries -----------------

def _mixed_chain(nd):
    """A chain whose stages differ in boundary: reflect, then constant."""
    first = _advect(nd) if nd == 2 else StencilStage(stencils.make_star(3, 1))
    return lambda: [
        StencilStage(first.stencil, coeffs=first.coeffs, boundary="reflect"),
        StencilStage(f"diffusion{nd}d",
                     boundary=("constant:0.0",) + ("reflect",) * (nd - 1))]


STORAGE_BC = [  # (id, program, dims, boundary, par_time, bsize, par_vec,
    # dtype): the three bodies in their three forms, ragged slab pads
    ("diffusion2d_bf16", _star("diffusion2d"), (37, 300), "clamp", 4, (64,),
     1, "bfloat16"),
    ("hotspot2d_periodic_bf16_v8", _star("hotspot2d"), (33, 517), "periodic",
     4, (128,), 8, "bfloat16"),
    ("diffusion3d_bf16_v2", _star("diffusion3d"), (21, 50, 45), "clamp", 3,
     (16, 16), 2, "bfloat16"),
    ("hotspot3d_bf16_v4", _star("hotspot3d"), (19, 37, 70),
     ("clamp", "periodic", "periodic"), 2, (12, 32), 4, "bfloat16"),
    ("advect_diffuse2d_rows_bf16_v4", lambda: [_advect(2),
                                               StencilStage("diffusion2d")],
     (37, 700), "clamp", 2, (300,), 4, "bfloat16"),
    ("damp2_chain_bf16", lambda: [StencilStage("diffusion2d"), _damp(2),
                                  _damp(2)], (20, 60), "clamp", 4, (12,), 1,
     "bfloat16"),
    ("wave2d_periodic_bf16_v4", lambda: _wave(2), (37, 300), "periodic", 4,
     (64,), 4, "bfloat16"),
    ("hotspot_dag_bf16", _hotspot_dag, (25, 170), ("clamp", "periodic"), 3,
     (32,), 1, "bfloat16"),
    ("wave3d_bf16", lambda: _wave(3), (17, 40, 35), "clamp", 2, (16, 16), 1,
     "bfloat16"),
    ("star1d_r2_bf16_v16", _star("star1d_r2"), (1001,), "clamp", 4, (), 16,
     "bfloat16"),
    ("diffusion2d_reflect_v4", _star("diffusion2d"), (37, 300), "reflect", 4,
     (64,), 4, "float32"),
    ("diffusion2d_constant", _star("diffusion2d"), (37, 300), "constant:1.5",
     4, (64,), 1, "float32"),
    ("diffusion2d_constant_bf16_v8", _star("diffusion2d"), (37, 300),
     "constant:1.5", 4, (64,), 8, "bfloat16"),
    ("hotspot2d_reflect_constant", _star("hotspot2d"), (33, 517),
     ("reflect", "constant:80.0"), 4, (128,), 1, "float32"),
    ("hotspot3d_mixed_v2", _star("hotspot3d"), (19, 37, 70),
     ("clamp", "reflect", "constant:0.0"), 2, (12, 32), 2, "float32"),
    ("diffusion3d_mixed_bf16_v4", _star("diffusion3d"), (21, 50, 45),
     ("reflect", "constant:0.5", "reflect"), 3, (16, 16), 4, "bfloat16"),
    ("mixed_chain2d", _mixed_chain(2), (37, 300), "clamp", 2, (64,), 1,
     "float32"),
    ("mixed_chain2d_bf16_v4", _mixed_chain(2), (37, 300), "clamp", 2, (64,),
     4, "bfloat16"),
    ("mixed_chain3d_v2", _mixed_chain(3), (21, 50, 45), "clamp", 2, (16, 16),
     2, "float32"),
    ("diamond_reflect", _diamond, (33, 150), "reflect", 2, (40,), 1,
     "float32"),
    ("diamond_constant_bf16_v4", _diamond, (33, 150), "constant:0.25", 2,
     (40,), 4, "bfloat16"),
    ("wave2d_reflect_constant_v2", lambda: _wave(2), (30, 211),
     ("reflect", "constant:0.0"), 3, (48,), 2, "float32"),
    ("wave3d_constant_bf16", lambda: _wave(3), (21, 30, 45), "constant:0.5",
     2, (16, 16), 1, "bfloat16"),
    ("star1d_r2_reflect_v4", _star("star1d_r2"), (1001,), "reflect", 4, (),
     4, "float32"),
    ("star1d_r1_constant_bf16", _star("star1d_r1"), (999,), "constant:2.0",
     3, (), 1, "bfloat16"),
]


def _storage_bc_case(case):
    _, program, dims, bc, par_time, bsize, V, dtype = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    cfg = dict(backend="hopper", par_time=par_time, bsize=bsize)
    return problem, cfg, V


@pytest.mark.parametrize("case", STORAGE_BC, ids=lambda c: c[0])
def test_storage_and_bc_kernel_equals_plain_version(cuda, case):
    """One super-step bit for bit against the plain version in the
    problem's storage dtype; NaN in the slab-pad rows changes nothing."""
    problem, cfg, V = _storage_bc_case(case)
    geom = plan(problem, RunConfig(par_vec=V, **cfg)).geometry
    g, aux = _state(problem, cuda, seed=9)
    gp, aux_p, dag, c, region, out = _superstep_vs_plain(problem, geom, g,
                                                         aux)
    assert out.dtype == problem.torch_dtype
    dom = builder._stream_dom(geom, problem.structural_bc)
    if gp.shape[-geom.ndim] > dom:
        poisoned = gp.clone()
        poisoned[(Ellipsis, slice(dom, None)) + (slice(None),) * (
            geom.ndim - 1)] = float("nan")
        again = torch.full_like(gp, float("nan"))
        builder.superstep_dag(dag, geom, poisoned, c, geom.par_time - 1,
                              aux_p, out=again)
        assert torch.equal(again[region], out[region])


@pytest.mark.parametrize("case", STORAGE_BC, ids=lambda c: c[0])
def test_storage_and_bc_plan_equals_v1_and_reference(cuda, case):
    """The plan launches ``ceil(iters/T)`` times, returns the storage dtype,
    equals the plan at V = 1 bit for bit and stays within
    ``precision.tolerance(dtype, iters, stages)`` of the reference."""
    problem, cfg, V = _storage_bc_case(case)
    iters = 2 * cfg["par_time"] + 1
    g, aux = _state(problem, cuda, seed=10)
    before = builder.LAUNCHES
    got = plan(problem, RunConfig(par_vec=V, **cfg)).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / cfg["par_time"])
    assert got.dtype == problem.torch_dtype
    v1 = plan(problem, RunConfig(par_vec=1, **cfg)).run(g, iters, aux=aux)
    assert torch.equal(got, v1)
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    scale = 100 if problem.needs_aux else None
    torch.testing.assert_close(v1, want, **precision.tolerance(
        problem.dtype, iters, stages=problem.n_stages, scale=scale))


# --- DAGs whose stages differ in boundary (B1k), wide planes and large
# tables (B1j) ----------------------------------------------------------------

def _mixed_diamond():
    """The diamond with ``a`` clamp, ``b`` reflect (it reads the field
    stream, padded under ``a``'s clamp) and the combine constant 0.5."""
    a, b, m = _diamond().stages
    return StencilProgram(
        (StencilStage(a.stencil, name="a", inputs=("u",), boundary="clamp"),
         StencilStage(b.stencil, name="b", inputs=("u",), coeffs=b.coeffs,
                      boundary="reflect"),
         StencilStage(m.stencil, name="m", inputs=("a", "b"),
                      coeffs=m.coeffs, boundary="constant:0.5")))


def _mixed_wave(nd):
    """The wave equation with a reflect Laplacian and a clamp combine."""
    lapu, unext = _wave(nd).stages
    return lambda: StencilProgram(
        (StencilStage(lapu.stencil, coeffs=lapu.coeffs, name="lapu",
                      inputs=("u",), boundary="reflect"),
         StencilStage(unext.stencil, coeffs=unext.coeffs, name="unext",
                      inputs=unext.inputs, boundary="clamp")),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _mixed_hotspot_dag():
    """The Hotspot DAG with its Hotspot stage under a constant stream axis
    and reflect x, the combine clamped."""
    h, m = _hotspot_dag().stages
    return StencilProgram(
        (StencilStage("hotspot2d", name="h", inputs=("u",),
                      boundary=("constant:80.0", "reflect")),
         StencilStage(m.stencil, name="m", inputs=m.inputs, coeffs=m.coeffs,
                      boundary="clamp")),
        fields=("u", "v"), updates={"u": "m", "v": "u"})


def _box_chain(nd, r):
    """Two ``make_box(nd, r)`` stages: 250 taps at (3, 2), past the kernel
    parameter's 128."""
    return lambda: [StencilStage(stencils.make_box(nd, r)),
                    StencilStage(stencils.make_box(nd, r))]


def _star_chain1d():
    return [StencilStage(stencils.make_star(1, 1)),
            StencilStage(stencils.make_star(1, 1))]


def _five_fields():
    """Five field streams, past the kernel parameter's table of 4."""
    five = tuple(f"f{i}" for i in range(5))
    return StencilProgram(
        (StencilStage(stencils.make_star(2, 1), name="a", inputs=("f0",)),),
        fields=five,
        updates={"f0": "a", **{five[i]: five[i - 1] for i in range(1, 5)}})


def _five_inputs_mixed():
    """A reflect combine of five inputs (past the parameter table's 4) over
    a clamped star."""
    return StencilProgram(
        (StencilStage(stencils.make_star(2, 1), name="a", inputs=("u",)),
         StencilStage(stencils.make_combine(2, 5), name="m",
                      inputs=("u", "a", "a", "u", "a"),
                      boundary="reflect")))


B1KJ = [  # (id, program, dims, boundary, par_time, bsize, par_vec, dtype):
    # mixed-boundary DAGs in the three thread forms (V = 1, one row, rows),
    # the wide form on the three bodies in both storage types, with and
    # without the boundary work, and the large-table route
    ("diamond_mixed", _mixed_diamond, (33, 150), "clamp", 2, (40,), 1,
     "float32"),
    ("diamond_mixed_bf16_v2", _mixed_diamond, (33, 150), "clamp", 2, (40,),
     2, "bfloat16"),
    ("wave2d_mixed_v8", _mixed_wave(2), (37, 600), "clamp", 3, (256,), 8,
     "float32"),
    ("wave3d_mixed", _mixed_wave(3), (21, 30, 45), "clamp", 2, (16, 16), 1,
     "float32"),
    ("hotspot_dag_mixed_bf16_v4", _mixed_hotspot_dag, (25, 170), "clamp", 3,
     (32,), 4, "bfloat16"),
    ("diffusion2d_wide", _star("diffusion2d"), (13, 3000), "clamp", 4,
     (2048,), 1, "float32"),
    ("hotspot2d_wide_bf16_v2", _star("hotspot2d"), (13, 3100), "reflect", 4,
     (1500,), 2, "bfloat16"),
    ("diffusion3d_wide_reflect", _star("diffusion3d"), (9, 70, 70),
     "reflect", 2, (40, 40), 1, "float32"),
    ("hotspot3d_wide_bf16_v2", _star("hotspot3d"), (9, 70, 75),
     ("clamp", "constant:80.0", "clamp"), 2, (36, 36), 2, "bfloat16"),
    ("advect_diffuse2d_wide", lambda: [_advect(2),
                                       StencilStage("diffusion2d")],
     (13, 3000), "clamp", 2, (1200,), 1, "float32"),
    ("wave2d_wide_periodic_v2", lambda: _wave(2), (13, 2500), "periodic", 2,
     (1100,), 2, "float32"),
    ("diamond_mixed_wide_bf16", _mixed_diamond, (13, 2500), "clamp", 2,
     (1100,), 1, "bfloat16"),
    ("box3d_r2_big", _box_chain(3, 2), (9, 40, 40), "clamp", 1, (20, 20), 1,
     "float32"),
    ("box3d_r2_big_reflect_bf16_v2", _box_chain(3, 2), (9, 40, 40),
     "reflect", 1, (20, 20), 2, "bfloat16"),
    ("star1d_chain_big_entries", _star_chain1d, (301,), "clamp", 40, (), 1,
     "float32"),
    ("wave2d_big_entries", lambda: _wave(2), (16, 128), "clamp", 20, (96,),
     1, "float32"),
    ("wave2d_mixed_big_bf16", _mixed_wave(2), (20, 200), "clamp", 17, (80,),
     1, "bfloat16"),
    # past the parameter table's tap coefficients (343 taps, an index past
    # a byte), field streams, inputs, and 16-bit ring slots (38,250)
    ("box3d_r3_big", lambda: [StencilStage(stencils.make_box(3, 3))],
     (8, 40, 40), "clamp", 1, (20, 20), 1, "float32"),
    ("five_fields_big", _five_fields, (16, 64), "clamp", 2, (32,), 1,
     "float32"),
    ("five_inputs_mixed_big_bf16_v2", _five_inputs_mixed, (16, 64), "clamp",
     2, (32,), 2, "bfloat16"),
    ("star1d_r127_big_slots", lambda: [StencilStage(stencils.make_star(1,
                                                                   127))],
     (700,), "clamp", 150, (), 1, "float32"),
]


@pytest.mark.parametrize("case", B1KJ, ids=lambda c: c[0])
def test_b1kj_kernel_equals_plain_version(cuda, case):
    """One super-step bit for bit against the plain version, with and
    without forwarding, through the form the case names: the
    mixed-boundary DAG body, the wide form, the large-table route."""
    problem, cfg, V = _storage_bc_case(case)
    geom = plan(problem, RunConfig(par_vec=V, **cfg)).geometry
    tab = builder.tables_of(geom, problem.exec_dag)
    if "mixed" in case[0]:
        assert builder.mixes_boundaries(problem.exec_dag, geom.ndim)
    if "wide" in case[0]:
        assert math.prod(geom.bsize) > blocking.MAX_THREADS
    if "big" in case[0]:
        assert tab is not None and tab.big
    g, aux = _state(problem, cuda, seed=11)
    _superstep_vs_plain(problem, geom, g, aux)


@pytest.mark.parametrize("case", B1KJ, ids=lambda c: c[0])
def test_b1kj_plan_matches_reference(cuda, case):
    """The plan launches ``ceil(iters/T)`` times, equals the plan at V = 1
    bit for bit and stays within ``precision.tolerance(dtype, iters,
    stages)`` of the reference backend."""
    problem, cfg, V = _storage_bc_case(case)
    iters = 2 * cfg["par_time"] + 1
    g, aux = _state(problem, cuda, seed=12)
    before = builder.LAUNCHES
    got = plan(problem, RunConfig(par_vec=V, **cfg)).run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / cfg["par_time"])
    if V > 1:
        v1 = plan(problem, RunConfig(par_vec=1, **cfg)).run(g, iters,
                                                            aux=aux)
        assert torch.equal(got, v1)
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    torch.testing.assert_close(got, want, **precision.tolerance(
        problem.dtype, iters, stages=problem.n_stages,
        scale=100 if problem.needs_aux else None))


# --- batches along the grid's z axis (B1f) ---------------------------------

BATCHES = [  # (id, program, dims, boundary, par_time, bsize, par_vec, dtype,
    # aux mode): the three bodies in their three forms, both storage types,
    # per-member and shared aux
    ("hotspot2d_member_aux", _star("hotspot2d"), (33, 517), "clamp", 4,
     (128,), 1, "float32", "member"),
    ("hotspot3d_shared_aux_v2", _star("hotspot3d"), (19, 37, 70), "clamp", 2,
     (12, 32), 2, "float32", "shared"),
    ("diffusion2d_bf16_v8", _star("diffusion2d"), (37, 300), "reflect", 4,
     (64,), 8, "bfloat16", None),
    ("advect_diffuse2d_bf16_v4", lambda: [_advect(2),
                                          StencilStage("diffusion2d")],
     (37, 700), "clamp", 2, (300,), 4, "bfloat16", None),
    ("mixed_chain2d", _mixed_chain(2), (37, 300), "clamp", 2, (64,), 1,
     "float32", None),
    ("wave2d_periodic", lambda: _wave(2), (37, 300), "periodic", 4, (64,), 1,
     "float32", None),
    ("hotspot_dag_member_aux", _hotspot_dag, (25, 170), ("clamp", "periodic"),
     3, (32,), 1, "float32", "member"),
    ("diamond_reflect_v4", _diamond, (33, 150), "reflect", 2, (40,), 4,
     "float32", None),
    ("star1d_r2_v16", _star("star1d_r2"), (1001,), "clamp", 4, (), 16,
     "float32", None),
    ("diamond_mixed_v2", _mixed_diamond, (33, 150), "clamp", 2, (40,), 2,
     "float32", None),
    ("hotspot2d_wide_bf16", _star("hotspot2d"), (13, 3100), "clamp", 4,
     (1500,), 1, "bfloat16", "member"),
    ("box3d_r2_big", _box_chain(3, 2), (9, 40, 40), "clamp", 1, (20, 20), 1,
     "float32", None),
]


def _batch_state(problem, n, aux_mode, device, seed):
    """``n`` states, and the aux: one per member or one shared grid."""
    parts = [_state(problem, device, seed + b) for b in range(n)]
    g = torch.stack([p[0] for p in parts])
    aux = None
    if aux_mode == "member":
        aux = torch.stack([p[1] for p in parts])
    elif aux_mode == "shared":
        aux = parts[0][1]
    return g, aux


@pytest.mark.parametrize("case", BATCHES, ids=lambda c: c[0])
def test_batched_launch_equals_single_launches(cuda, case):
    """One launch over a batch of 3 equals 3 single launches and the
    batched plain version bit for bit, with and without forwarding."""
    _, program, dims, bc, par_time, bsize, V, dtype, aux_mode = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V)).geometry
    g, aux = _batch_state(problem, 3, aux_mode, cuda, seed=20)
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        before = builder.LAUNCHES
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out)
        torch.cuda.synchronize()
        assert builder.LAUNCHES == before + 1
        plain = torch.full_like(gp, float("nan"))
        builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p, plain)
        assert torch.equal(out.nan_to_num(-7.0), plain.nan_to_num(-7.0))
        for b in range(3):
            single = torch.full_like(gp[b], float("nan"))
            builder.superstep_dag(
                dag, geom, gp[b].contiguous(), c, steps,
                aux_p[b].contiguous() if aux_mode == "member" else aux_p,
                out=single)
            assert torch.equal(out[b].nan_to_num(-7.0),
                               single.nan_to_num(-7.0)), b


@pytest.mark.parametrize("case", BATCHES, ids=lambda c: c[0])
def test_run_batch_on_card_equals_sequential_runs(cuda, case):
    """``run_batch`` launches ``ceil(iters/T)`` times for the whole batch
    and equals the members' sequential ``run``s bit for bit."""
    _, program, dims, bc, par_time, bsize, V, dtype, aux_mode = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    p = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize, par_vec=V))
    iters = 2 * par_time + 1
    g, aux = _batch_state(problem, 4, aux_mode, cuda, seed=30)
    before = builder.LAUNCHES
    got = p.run_batch(g, iters, aux=aux)
    torch.cuda.synchronize()
    assert builder.LAUNCHES - before == math.ceil(iters / par_time)
    for b in range(4):
        a = aux[b] if aux_mode == "member" else aux
        assert torch.equal(got[b], p.run(g[b], iters, aux=a)), b


def test_batch_offsets_past_2_31_cells(cuda):
    """A batch of 4 wave2d states at 16384^2 (2 fields each: 4 x 2 x
    16392 x 16400 = 2.15e9 padded cells, past 2^31): the members whose
    cells lie past 2^31 (member 3) and before it (member 0) equal single
    launches on copies of those members bit for bit."""
    problem = StencilProblem(_wave(2), (16384, 16384), boundary="periodic")
    geom = plan(problem, RunConfig(backend="hopper", par_time=4,
                                   bsize=(256,))).geometry
    dag, bc0 = problem.exec_dag, problem.structural_bc
    shape = builder._stream_shape(geom, bc0, 2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    gp = torch.empty((4,) + shape, device=cuda).uniform_(0.5, 2.0,
                                                         generator=gen)
    assert gp.numel() > 2 ** 31
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    # the outputs start as NaN: the cells a launch does not write (halo,
    # overhang) must stay NaN in both
    out = torch.full_like(gp, float("nan"))
    builder.superstep_dag(dag, geom, gp, c, 4, out=out)
    torch.cuda.synchronize()
    h = geom.size_halo
    region = (Ellipsis, slice(0, builder._stream_dom(geom, bc0))) + tuple(
        slice(h, h + n * cs) for n, cs in zip(geom.bnum, geom.csize))
    for b in (0, 3):
        assert not out[b][region].isnan().any(), b
        single = torch.full_like(gp[b], float("nan"))
        builder.superstep_dag(dag, geom, gp[b].clone(), c, 4, out=single)
        torch.cuda.synchronize()
        assert torch.equal(out[b].nan_to_num(-7.0),
                           single.nan_to_num(-7.0)), b
        del single


# --- stencils with a custom apply (device functions generated per program) --

def _lap2d(x):
    return x((-1, 0)) + x((1, 0)) + x((0, -1)) + x((0, 1)) - 4.0 * x((0, 0))


def _allen_cahn(get, c, aux=None):
    u = get((0, 0))
    return u + c["dt"] * (c["d"] * _lap2d(get) + u - u * u * u)


ALLEN_CAHN = stencils.Stencil("allen_cahn2d", 2, 1, 12, 1, 1, False,
                              ("dt", "d"), _allen_cahn)


def _gray_scott_u(gets, c, aux=None):
    u, v = gets[0]((0, 0)), gets[1]((0, 0))
    return u + c["dt"] * (c["Du"] * _lap2d(gets[0]) - u * v * v
                          + c["F"] * (1.0 - u))


def _gray_scott_v(gets, c, aux=None):
    v, u = gets[0]((0, 0)), gets[1]((0, 0))
    return v + c["dt"] * (c["Dv"] * _lap2d(gets[0]) + u * v * v
                          - c["Fk"] * v)


def _upwind(get, c, aux):
    u = get((0, 0, 0))
    return u - c["dt"] * (torch.clamp(aux, min=0.0) * (u - get((0, 0, -1)))
                          + torch.clamp(aux, max=0.0) * (get((0, 0, 1)) - u))


UPWIND = stencils.Stencil("upwind3d", 3, 1, 9, 2, 1, True, ("dt",), _upwind)


def _allen_cahn_stage(**kw):
    return StencilStage(ALLEN_CAHN, coeffs={"dt": 0.1, "d": 0.2}, **kw)


def _gray_scott():
    """Pearson's two-field reaction-diffusion, one custom stage per field,
    each tapping its own field at radius 1 and reading the other's
    centre."""
    gs_u = stencils.Stencil("gs_u", 2, 1, 15, 2, 1, False, ("Du", "F", "dt"),
                            _gray_scott_u, arity=2)
    gs_v = stencils.Stencil("gs_v", 2, 1, 15, 2, 1, False, ("Dv", "Fk", "dt"),
                            _gray_scott_v, arity=2)
    return StencilProgram(
        (StencilStage(gs_u, name="un", inputs=("u", "v"),
                      coeffs={"Du": 0.16, "F": 0.035, "dt": 1.0}),
         StencilStage(gs_v, name="vn", inputs=("v", "u"),
                      coeffs={"Dv": 0.08, "Fk": 0.095, "dt": 1.0})),
        fields=("u", "v"), updates={"u": "un", "v": "vn"})


def _upwind_stage():
    return [StencilStage(UPWIND, coeffs={"dt": 0.3})]


def _fanin3_custom():
    """A custom stage of three inputs that taps input 2 at radius 1 and
    input 0 off centre."""
    def apply(gets, c, aux=None):
        u, v, w = gets
        return (c["a"] * u((0, 1)) + v((0, 0)) * (w((-1, 0)) - w((1, 0)))
                + c["b"] * w((0, -1)) * w((0, 1)))
    st = stencils.Stencil("fanin3", 2, 1, 8, 3, 1, False, ("a", "b"), apply,
                          arity=3)
    return StencilProgram(
        (StencilStage(st, name="f", inputs=("u", "v", "w"),
                      coeffs={"a": 0.5, "b": 0.25}),),
        fields=("u", "v", "w"), updates={"u": "f", "v": "u"})


def _custom_mixed():
    """A custom stage under reflect beside a clamped star, recombined under
    constant 0.5: the mixed-boundary body's getter form on grid-edge
    CTAs."""
    s = stencils.make_star(2, 1)
    return StencilProgram(
        (_allen_cahn_stage(name="a", inputs=("u",), boundary="reflect"),
         StencilStage(s, name="b", inputs=("u",), boundary="clamp"),
         StencilStage(stencils.make_combine(2, 2), name="m",
                      inputs=("a", "b"), coeffs={"w0": 0.6, "w1": 0.4},
                      boundary="constant:0.5")))


def _custom_big():
    """65 entries (a custom radius-1 stage and four custom radius-0 ones at
    T = 13): past the kernel parameter's 64."""
    def damp(get, c, aux=None):
        u = get((0, 0))
        return u * (c["k"] - 0.5 * u * u)
    st = stencils.Stencil("cubic_damp", 2, 0, 4, 1, 1, False, ("k",), damp)
    return [_allen_cahn_stage()] + [StencilStage(st, coeffs={"k": 1.5})] * 4


def _transcendental():
    def apply(get, c, aux=None):
        u = get((0, 0))
        lap = _lap2d(get)
        return u + c["dt"] * (torch.tanh(lap) - 0.1 * torch.sin(u)
                              + 0.05 * u.cos() + 0.01 * torch.log(u)
                              + 0.01 * torch.sqrt(u) * torch.exp(-u))
    st = stencils.Stencil("transcendental2d", 2, 1, 20, 1, 1, False,
                          ("dt",), apply)
    return [StencilStage(st, coeffs={"dt": 0.1})]


CUSTOM = [  # (id, program, dims, boundary, par_time, bsize, par_vec, dtype,
    # ulp-bounded): the four chip cells at small size in the forms and
    # bodies the op takes; the transcendental case within
    # precision.tolerance (16 ulps an iteration), every other bit for bit
    ("allen_cahn2d", lambda: [_allen_cahn_stage()], (40, 300), "clamp", 4,
     (64,), 1, "float32", False),
    ("allen_cahn2d_bf16_v4", lambda: [_allen_cahn_stage()], (37, 300),
     "clamp", 4, (64,), 4, "bfloat16", False),
    ("allen_cahn2d_reflect_rows_v4", lambda: [_allen_cahn_stage()],
     (37, 700), "reflect", 2, (300,), 4, "float32", False),
    ("gray_scott2d", _gray_scott, (37, 300), "periodic", 4, (64,), 1,
     "float32", False),
    ("gray_scott2d_constant_v2", _gray_scott, (37, 300), "constant:0.0", 3,
     (64,), 2, "float32", False),
    ("upwind3d", _upwind_stage, (19, 37, 70), "clamp", 2, (12, 32), 1,
     "float32", False),
    ("upwind3d_wide_bf16", _upwind_stage, (9, 45, 50), "clamp", 2, (40, 40),
     1, "bfloat16", False),
    ("fanin3", _fanin3_custom, (29, 130), "periodic", 2, (32,), 1,
     "float32", False),
    ("custom_mixed", _custom_mixed, (33, 150), "clamp", 2, (40,), 1,
     "float32", False),
    ("custom_mixed_bf16_v2", _custom_mixed, (33, 150), "clamp", 2, (40,), 2,
     "bfloat16", False),
    ("custom_big", _custom_big, (20, 200), "clamp", 13, (64,), 1, "float32",
     False),
    ("transcendental2d", _transcendental, (40, 300), "clamp", 4, (64,), 1,
     "float32", True),
]


def _custom_case(case):
    _, program, dims, bc, par_time, bsize, V, dtype, ulps = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    cfg = dict(backend="hopper", par_time=par_time, bsize=bsize, par_vec=V)
    return problem, cfg, ulps


def _custom_state(problem, device, seed):
    """Fields ``uniform(0, 1)`` (the physical range of u and v) and a
    standard normal aux (a velocity), in the storage dtype."""
    rng = np.random.default_rng(seed)
    dt = problem.torch_dtype
    g = torch.from_numpy(rng.uniform(0.0, 1.0, problem.state_shape)
                         .astype(np.float32)).to(device, dt)
    aux = None
    if problem.needs_aux:
        aux = torch.from_numpy(rng.standard_normal(problem.shape)
                               .astype(np.float32)).to(device, dt)
    return g, aux


@pytest.mark.parametrize("case", CUSTOM, ids=lambda c: c[0])
def test_custom_kernel_equals_plain_version(cuda, case):
    """One super-step through the program's generated library against the
    plain version (``apply`` in torch ops on the card), with and without
    forwarding: bit for bit where the trace uses only ``+ - * /``, neg,
    abs, min, max and where."""
    problem, cfg, ulps = _custom_case(case)
    geom = plan(problem, RunConfig(**cfg)).geometry
    dag = problem.exec_dag
    assert builder.custom_library(dag, geom, problem.torch_dtype).exists()
    tab = builder.tables_of(geom, dag)
    if "mixed" in case[0]:
        assert builder.mixes_boundaries(dag, geom.ndim)
    if "wide" in case[0]:
        assert math.prod(geom.bsize) > blocking.MAX_THREADS
    if "big" in case[0]:
        assert tab.big
    g, aux = _custom_state(problem, cuda, seed=40)
    if not ulps:
        _superstep_vs_plain(problem, geom, g, aux)
        return
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    h = geom.size_halo
    region = (Ellipsis, slice(0, builder._stream_dom(geom, bc0))) + tuple(
        slice(h, h + n * cs) for n, cs in zip(geom.bnum, geom.csize))
    for steps in (geom.par_time, geom.par_time - 1):
        out = builder.superstep_dag(dag, geom, gp, c, steps)
        want = builder.superstep_dag_plain(dag, geom, gp, c, steps, None,
                                           torch.empty_like(gp))
        torch.testing.assert_close(out[region], want[region],
                                   **precision.tolerance("float32", steps))


@pytest.mark.parametrize("case", CUSTOM, ids=lambda c: c[0])
def test_custom_plan_matches_reference(cuda, case):
    """The plan launches ``ceil(iters/T)`` times and stays within
    ``precision.tolerance(dtype, iters, stages)`` of the reference
    backend; a batch of 2 equals its members' runs bit for bit."""
    problem, cfg, _ = _custom_case(case)
    iters = 2 * cfg["par_time"] + 1
    g, aux = _custom_state(problem, cuda, seed=41)
    p = plan(problem, RunConfig(**cfg))
    before = builder.LAUNCHES
    got = p.run(g, iters, aux=aux)
    assert builder.LAUNCHES - before == math.ceil(iters / cfg["par_time"])
    want = plan(problem, RunConfig(backend="reference")).run(g, iters,
                                                             aux=aux)
    torch.testing.assert_close(got, want, **precision.tolerance(
        problem.dtype, iters, stages=problem.n_stages))
    batch = torch.stack([g, g.flip(0)])
    both = p.run_batch(batch, iters, aux=aux)
    assert torch.equal(both[0], got)
    assert torch.equal(both[1], p.run(batch[1], iters, aux=aux))


# --- the stream split across CTAs --------------------------------------------

SPLIT = [  # (id, program, dims, boundary, par_time, bsize, par_vec, dtype,
    # segments, batch and its aux): the stream cut into more segments than
    # the launcher's plan would, a few slabs each, the last one ragged
    ("diffusion2d_ragged", _star("diffusion2d"), (203, 300), "clamp", 4,
     (64,), 1, "float32", 8, None),
    ("hotspot2d_two_slabs", _star("hotspot2d"), (150, 300), "clamp", 8,
     (64,), 1, "float32", 75, None),
    ("diffusion2d_periodic", _star("diffusion2d"), (101, 300), "periodic",
     4, (64,), 1, "float32", 9, None),
    ("hotspot2d_reflect", _star("hotspot2d"), (101, 517), "reflect", 4,
     (128,), 1, "float32", 9, None),
    ("diffusion2d_reflect_overhang", _star("diffusion2d"), (97, 300),
     "reflect", 4, (64,), 1, "float32", 8, None),
    ("diffusion2d_constant_bf16", _star("diffusion2d"), (101, 300),
     "constant:1.5", 4, (64,), 1, "bfloat16", 9, None),
    ("diffusion2d_t12", _star("diffusion2d"), (203, 300), "clamp", 12,
     (64,), 1, "float32", 5, None),
    ("diffusion3d_reflect_v2", _star("diffusion3d"), (61, 50, 45),
     "reflect", 3, (16, 16), 2, "float32", 6, None),
    ("hotspot3d_mixed", _star("hotspot3d"), (47, 37, 70),
     ("clamp", "reflect", "constant:0.0"), 2, (12, 32), 1, "float32", 5,
     None),
    ("diffusion2d_v4_bf16", _star("diffusion2d"), (203, 300), "clamp", 8,
     (64,), 4, "bfloat16", 11, None),
    ("mixed_chain2d_v2", _mixed_chain(2), (157, 300), "clamp", 2, (64,), 2,
     "float32", 10, None),
    ("advect_diffuse2d_batch", lambda: [_advect(2),
                                        StencilStage("diffusion2d")],
     (131, 300), "clamp", 3, (64,), 1, "float32", 8, (3, None)),
    ("hotspot2d_batch_bf16", _star("hotspot2d"), (77, 517), "clamp", 4,
     (128,), 1, "bfloat16", 6, (3, "member")),
    ("star1d_r2", _star("star1d_r2"), (1001,), "clamp", 4, (), 1, "float32",
     40, None),
    ("star1d_r2_v16_reflect", _star("star1d_r2"), (1001,), "reflect", 4, (),
     16, "float32", 12, None),
    ("diffusion2d_wide", _star("diffusion2d"), (103, 2500), "clamp", 4,
     (1100,), 1, "float32", 8, None),
    ("allen_cahn2d_custom", lambda: [_allen_cahn_stage()], (103, 300),
     "clamp", 4, (64,), 1, "float32", 9, None),
    ("box3d_r2_big", _box_chain(3, 2), (41, 40, 40), "clamp", 1, (20, 20),
     1, "float32", 5, None),
]


@pytest.mark.parametrize("case", SPLIT, ids=lambda c: c[0])
def test_split_stream_equals_plain_version(cuda, case):
    """One super-step with the stream cut into about ``segments`` segments
    (the launcher's private argument), bit for bit against the plain
    version into a NaN-filled output, with and without forwarding: each
    segment's warm-up rebuilds the rows before it, and each output row is
    written by one CTA."""
    _, program, dims, bc, par_time, bsize, V, dtype, segments, batch = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V)).geometry
    if batch is None:
        g, aux = _state(problem, cuda, seed=50)
    else:
        g, aux = _batch_state(problem, batch[0], batch[1], cuda, seed=50)
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    nslabs = gp.shape[-geom.ndim] // V
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out,
                              _segments=segments)
        torch.cuda.synchronize()
        split = builder.LAST_SPLIT
        assert split.nseg > 1 and split.nseg == -(-nslabs // split.seg)
        assert split.warm == builder.stream_warmup(dag, geom)
        assert split.ctas == split.nseg * math.prod(geom.bnum) * (
            1 if batch is None else batch[0])
        plain = torch.full_like(gp, float("nan"))
        builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p, plain)
        assert torch.equal(out.nan_to_num(-7.0), plain.nan_to_num(-7.0))
    if case[0] == "diffusion2d_ragged":
        assert nslabs % split.seg != 0
    if "big" in case[0]:
        assert builder.tables_of(geom, dag).big
    if builder.is_main_path(dag):
        assert split.barriers == 1
        assert (split.look > 0) == (V == 1 and par_time <= 16
                                    and math.prod(bsize) <= 1024)


# --- the DAG bodies' stream split and one-barrier form -----------------------

SPLIT_DAGS = [  # (id, program, dims, boundary, par_time, bsize, par_vec,
    # dtype, segments, batch and its aux): every DAGS case and the
    # mixed-boundary, custom, batch, bf16, V > 1, wide and large-table DAGs,
    # the stream cut into a few slabs a segment
    *[(f"{c[0]}_split", c[1], c[2], c[3], c[4], c[5], 1, "float32",
       4 if len(c[2]) == 3 else 6, None) for c in DAGS],
    ("diamond_reflect_overhang", _diamond, (33, 150), "reflect", 2, (40,), 1,
     "float32", 6, None),
    ("diamond_mixed", _mixed_diamond, (33, 150), "clamp", 2, (40,), 1,
     "float32", 6, None),
    ("diamond_mixed_bf16", _mixed_diamond, (33, 150), "clamp", 2, (40,), 1,
     "bfloat16", 6, None),
    ("wave3d_mixed", _mixed_wave(3), (21, 30, 45), "clamp", 2, (16, 16), 1,
     "float32", 4, None),
    ("hotspot_dag_mixed_bf16", _mixed_hotspot_dag, (25, 170), "clamp", 3,
     (32,), 1, "bfloat16", 5, None),
    ("gray_scott2d", _gray_scott, (37, 300), "periodic", 4, (64,), 1,
     "float32", 6, None),
    ("fanin3_custom", _fanin3_custom, (29, 130), "periodic", 2, (32,), 1,
     "float32", 5, None),
    ("custom_mixed", _custom_mixed, (33, 150), "clamp", 2, (40,), 1,
     "float32", 6, None),
    ("wave2d_batch", lambda: _wave(2), (37, 300), "periodic", 4, (64,), 1,
     "float32", 6, (3, None)),
    ("hotspot_dag_batch_member_aux", _hotspot_dag, (25, 170),
     ("clamp", "periodic"), 3, (32,), 1, "float32", 5, (3, "member")),
    ("wave2d_bf16", lambda: _wave(2), (37, 300), "periodic", 4, (64,), 1,
     "bfloat16", 6, None),
    ("wave2d_v4", lambda: _wave(2), (37, 300), "periodic", 4, (64,), 4,
     "float32", 3, None),
    ("diamond_mixed_v2", _mixed_diamond, (33, 150), "clamp", 2, (40,), 2,
     "float32", 4, None),
    ("wave2d_wide_periodic", lambda: _wave(2), (33, 2500), "periodic", 2,
     (1100,), 1, "float32", 5, None),
    ("wave2d_big_entries", lambda: _wave(2), (40, 128), "clamp", 20, (96,),
     1, "float32", 3, None),
]


@pytest.mark.parametrize("case", SPLIT_DAGS, ids=lambda c: c[0])
def test_split_dag_equals_plain_version(cuda, case):
    """One DAG super-step with the stream cut into about ``segments``
    segments, bit for bit against the plain version into a NaN-filled
    output, with and without forwarding through the state nodes: the
    one-barrier form (one barrier a tick) wherever ``win_form`` allows it,
    else a per-entry-barrier form that says why; a batch equals its
    members' single split launches, and V > 1 equals V = 1 on the stream's
    rows."""
    _, program, dims, bc, par_time, bsize, V, dtype, segments, batch = case
    problem = StencilProblem(program(), dims, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V)).geometry
    if batch is None:
        g, aux = _state(problem, cuda, seed=60)
    else:
        g, aux = _batch_state(problem, batch[0], batch[1], cuda, seed=60)
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    dag = problem.exec_dag
    assert problem.is_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    nslabs = gp.shape[-geom.ndim] // V
    why = builder.win_form(dag, geom, gp.element_size())
    h = geom.size_halo
    rows = (Ellipsis, slice(0, builder._stream_dom(geom, bc0))) + tuple(
        slice(h, h + n * cs) for n, cs in zip(geom.bnum, geom.csize))
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out,
                              _segments=segments)
        torch.cuda.synchronize()
        split = builder.LAST_SPLIT
        assert split.nseg > 1 and split.nseg == -(-nslabs // split.seg)
        assert split.warm == builder.stream_warmup(dag, geom)
        if why is None:
            assert split.barriers == 1
            assert split.kernel.startswith("dag_kernel<")
        else:
            assert split.barriers == split_entries(dag, par_time) + 1
            assert why in split.form
        plain = torch.full_like(gp, float("nan"))
        builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p, plain)
        assert torch.equal(out.nan_to_num(-7.0), plain.nan_to_num(-7.0))
        if batch is not None:
            for b in range(batch[0]):
                single = torch.full_like(gp[b], float("nan"))
                builder.superstep_dag(
                    dag, geom, gp[b].contiguous(), c, steps,
                    aux_p[b].contiguous() if batch[1] == "member" else aux_p,
                    out=single, _segments=segments)
                assert torch.equal(out[b].nan_to_num(-7.0),
                                   single.nan_to_num(-7.0)), b
        if V > 1:
            geom1 = plan(problem, RunConfig(
                backend="hopper", par_time=par_time, bsize=bsize,
                par_vec=1)).geometry
            gp1 = ops._pad_blocked(g, geom1, bc0)
            aux1 = None if aux is None else ops._pad_blocked(aux, geom1,
                                                             bc0)
            out1 = torch.full_like(gp1, float("nan"))
            builder.superstep_dag(dag, geom1, gp1, c, steps, aux1, out=out1,
                                  _segments=segments * V)
            assert torch.equal(out[rows], out1[rows])
    if "mixed" in case[0]:
        assert builder.mixes_boundaries(dag, geom.ndim)
    if "reflect_overhang" in case[0]:
        assert why is not None and "reflect" in why


def split_entries(dag, par_time):
    """The unrolled entries of ``dag``: a per-entry-barrier form takes one
    barrier after each, and one after the push."""
    from repro_torch.programs import unroll_dag
    return len(unroll_dag(dag, par_time).entries)


# --- the chain body's one-barrier form ---------------------------------------

def _reflect_chain():
    """advect then diffusion, both reflect: the kinds of a consumer follow
    those of the value it reads."""
    first = _advect(2)
    return [StencilStage(first.stencil, coeffs=first.coeffs,
                         boundary="reflect"),
            StencilStage("diffusion2d", boundary="reflect")]


def _kinds_do_not_follow():
    """advect under reflect, then diffusion under constant 0.5: the
    advect of the next iteration maps a cell under reflect where the
    value it reads took the fill."""
    first = _advect(2)
    return [StencilStage(first.stencil, coeffs=first.coeffs,
                         boundary="reflect"),
            StencilStage("diffusion2d", boundary="constant:0.5")]


def _star1d_chain():
    return [StencilStage(stencils.make_star(1, 2)),
            StencilStage(stencils.make_star(1, 1))]


def _long_chain():
    """18 entries at T = 6: past the register form's 8, the ring form."""
    return [StencilStage("diffusion2d"), _damp(2),
            StencilStage(stencils.make_box(2, 1))]


CHAIN_FORMS = [  # (id, stages, dims, boundary, par_time, bsize, dtype,
    # batch members, the kernel it runs: chain_win_kernel<bc,kT> or
    # chain_kernel)
    *[(c[0], c[1], c[2], "clamp", c[3], c[4], "float32", None,
       "chain_kernel" if c[0] == "diffusion2d_t80" else "chain_win_kernel")
      for c in PROGRAMS if c[0] != "diffusion2d_t80"],
    ("chain_clamp_periodic", PERIODIC[2][1], (33, 200), ("clamp", "periodic"),
     2, (64,), "float32", None, "chain_win_kernel"),
    ("chain3d_periodic", PERIODIC[3][1], (21, 50, 45),
     ("periodic", "clamp", "periodic"), 2, (16, 16), "float32", None,
     "chain_win_kernel"),
    ("reflect_chain", _reflect_chain, (40, 300), "clamp", 3, (64,),
     "float32", None, "chain_win_kernel"),
    ("mixed_chain", _mixed_chain(2), (40, 300), "clamp", 3, (64,),
     "float32", None, "chain_win_kernel"),
    ("kinds_do_not_follow", _kinds_do_not_follow, (40, 300), "clamp", 3,
     (64,), "float32", None, "chain_kernel"),
    ("advect_diffuse2d_bf16", PROGRAMS[0][1], (40, 300), "clamp", 3, (64,),
     "bfloat16", None, "chain_win_kernel"),
    ("star_diffuse3d_bf16", PROGRAMS[2][1], (21, 50, 45), "clamp", 2,
     (16, 16), "bfloat16", None, "chain_win_kernel"),
    ("reflect_chain_bf16", _reflect_chain, (40, 300), "clamp", 3, (64,),
     "bfloat16", None, "chain_win_kernel"),
    ("allen_cahn2d", lambda: [_allen_cahn_stage()], (37, 300), "clamp", 4,
     (64,), "float32", None, "chain_win_kernel"),
    ("upwind3d", lambda: [StencilStage(UPWIND, coeffs={"dt": 0.3})],
     (19, 37, 70), "clamp", 3, (12, 32), "float32", None,
     "chain_win_kernel"),
    ("advect_diffuse2d_batch", PROGRAMS[0][1], (40, 300), "clamp", 3, (64,),
     "float32", 3, "chain_win_kernel"),
    ("star1d_chain", _star1d_chain, (3000,), "clamp", 4, (), "float32",
     None, "chain_kernel"),
    ("advect_diffuse2d_bf16_odd_plane", PROGRAMS[0][1], (40, 245), "clamp",
     4, (65,), "bfloat16", None, "chain_kernel"),
    ("long_chain_ring_form", _long_chain, (30, 400), "clamp", 6, (96,),
     "float32", None, "chain_win_kernel"),
    ("reflect_overhang_past_the_grid", _reflect_chain, (64, 300), "clamp", 2,
     (96,), "float32", None, "chain_kernel"),
]


@pytest.mark.parametrize("case", CHAIN_FORMS, ids=lambda c: c[0])
def test_chain_form_equals_plain_version(cuda, case, monkeypatch):
    """The chain body's one-barrier form, one barrier a tick
    (``chain_win_kernel``: the register form, or past its entries the ring
    form), bit for bit against the plain version into a NaN-filled output,
    with and without PE forwarding, on the chain cases above: every
    ``PROGRAMS`` case, periodic and mixed-boundary chains, bf16, custom
    ``apply`` chains (Allen-Cahn, upwind transport with an aux velocity),
    a batch, a 3D chain; each of them again with the stream cut into 3
    segments, so that a segment starts after a warm-up inside the stream;
    the register form equal to the ring form bit for bit (but in a custom
    library, which holds one kernel).  A chain whose
    consumer re-imposes under other blocked-axis kinds, one whose reflect
    overhang mirrors past the grid (``own_columns``), a 1D chain and a
    bfloat16 chain on a padded plane of an odd count of cells keep
    ``chain_kernel`` and say why."""
    _, stages, dims, bc, par_time, bsize, dtype, batch, kernel = case
    problem = StencilProblem(stages(), dims, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize)).geometry
    if batch is None:
        g, aux = _state(problem, cuda, seed=70)
    else:
        g, aux = _batch_state(problem, batch, None, cuda, seed=70)
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    why = builder.win_form(dag, geom, gp.element_size())
    assert (why is None) == (kernel == "chain_win_kernel"), why
    if case[0] == "reflect_overhang_past_the_grid":
        assert why.startswith("reflect maps")
    if case[0] == "kinds_do_not_follow":
        assert why.startswith("a stage's consumer")
    if case[0] == "star1d_chain":
        assert why.startswith("a one-cell")
    if case[0] == "advect_diffuse2d_bf16_odd_plane":
        assert why.startswith("a bfloat16 stream")
    if case[0] == "long_chain_ring_form":
        assert builder.launch_form(dag, geom, gp.element_size()) == (True, 0)
    # the form the launcher picks; where it is the one-barrier form, the
    # stream forced into 3 segments (a warm-up inside the stream) and,
    # but in a custom library (one kernel), the ring form
    runs = [(False, None)]
    if why is None:
        runs.append((False, 3))
        if not builder.custom_stencils(problem.exec_stages):
            runs.append((True, None))
    for steps in (par_time, par_time - 1):
        outs = []
        for ring, segments in runs:
            if ring:        # the ring form, by the unroll the launch asks for
                monkeypatch.setattr(builder, "chain_unroll", lambda n: 0)
                builder.launch_form.cache_clear()
                builder._prepared.cache_clear()
            out = torch.full_like(gp, float("nan"))
            builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out,
                                  _segments=segments)
            torch.cuda.synchronize()
            split = builder.LAST_SPLIT
            assert split.kernel.startswith(kernel + "<"), split.kernel
            assert split.barriers == (1 if why is None else
                                      split_entries(dag, par_time) + 1)
            if why is not None:
                assert why in split.form
            if segments is not None:
                assert split.nseg > 1, split
            if ring:
                assert split.kernel.endswith(",0>"), split.kernel
                monkeypatch.undo()
                builder.launch_form.cache_clear()
                builder._prepared.cache_clear()
            outs.append(out)
        plain = torch.full_like(gp, float("nan"))
        builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p, plain)
        for out in outs:
            assert torch.equal(out.nan_to_num(-7.0), plain.nan_to_num(-7.0))


@pytest.mark.parametrize("name", ["diffusion2d", "hotspot2d"])
def test_bf16_main_path_on_an_odd_plane_equals_plain_version(cuda, name):
    """A bfloat16 grid whose padded plane holds an odd count of cells (px
    293 at bsize 65, T 4: every other stream row starts on the other half
    of a 4-byte word) runs the main path's ring form, whose copies are
    cells, not the register form, whose copies ahead are words laid out
    from the first row's shift (it computed other values there); one
    super-step bit for bit against the plain version, with and without
    forwarding, and a plane of an even count still takes the register
    form."""
    st = stencils.STENCILS[name]
    for dims, odd in (((40, 280), True), ((40, 300), False)):
        problem = StencilProblem(name, dims, dtype="bfloat16")
        geom = plan(problem, RunConfig(backend="hopper", par_time=4,
                                       bsize=(65,))).geometry
        assert (math.prod(geom.padded_dims) % 2 == 1) == odd
        assert (builder.main_look(geom, 2) == 0) == odd
        g, aux = _state(problem, cuda, seed=80)
        gp = ops._pad_blocked(g, geom)
        aux_p = None if aux is None else ops._pad_blocked(aux, geom)
        c = ops.pack_coeffs(st, stencils.default_coeffs(st))
        for steps in (4, 3):
            out = torch.full_like(gp, float("nan"))
            builder.superstep_chain(((st, None),), geom, gp, c, steps, aux_p,
                                    out=out)
            torch.cuda.synchronize()
            kt = builder.LAST_SPLIT.kernel.split(",")[-1]
            assert (kt == "0>") == odd, builder.LAST_SPLIT.kernel
            plain = builder.superstep_plain(((st, None),), geom, gp, c,
                                            steps, aux_p,
                                            torch.full_like(gp, float("nan")))
            assert torch.equal(out.nan_to_num(-7.0), plain.nan_to_num(-7.0))
