"""The ``distributed`` backend (``core/distributed.py``) and its meshes
(``launch/mesh.py``) on in-process CPU meshes of 2, 4 and 2×2 shards:
split along the streaming axis and along blocked axes, 2D and 3D, radius 1
and 2, periodic, reflect, constant and clamp, a chain, DAGs (the wave
equation, the diamond whose halo is its critical path, not its summed
radius), aux, batches and bf16.  Every case equals the port's single-device
``engine`` bit for bit and lies within
``repro_torch.core.precision.tolerance`` of the port's oracle;
``tests/torch_distributed_check.py`` holds nine of them against the
reference's ``distributed`` backend on 4 fake devices.  Also: the counted
exchanges and their bytes, the ``distributed.exchange`` fault point, the
plan-time refusals, the mesh, and the model's view of shards."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import distributed, perf_model, precision, stencils
from repro_torch.launch.mesh import Mesh, dp_axes, make_mesh
from repro_torch.resilience import (FaultPlan, FaultSpec, InjectedFault,
                                    registered_points)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _star2d_r2():
    return stencils.make_star(2, 2)


def _star3d_r2():
    return stencils.make_star(3, 2)


def _chain():
    return [StencilStage(stencils.make_star(2, 2), boundary="reflect"),
            StencilStage("diffusion2d")]


def _wave():
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return StencilProgram(
        (StencilStage(stencils.make_star(2, 1), coeffs=lap, name="lapu",
                      inputs=("u",)),
         StencilStage(stencils.make_combine(2, 3), name="unext",
                      inputs=("u", "u_prev", "lapu"),
                      coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond():
    s = stencils.make_star(2, 1)
    return StencilProgram(
        (StencilStage(s, name="a", inputs=("u",)),
         StencilStage(s, name="b", inputs=("u",),
                      coeffs={"c0": 0.5, "c_0_1": 0.2}),
         StencilStage(stencils.make_combine(2, 2), name="m",
                      inputs=("a", "b"), coeffs={"w0": 0.6, "w1": 0.4})))


def _data(problem, seed=0, batch=None, aux_batch=False):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    g = rng.uniform(0.5, 2.0, lead + problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.uniform(0.0, 0.1, (lead if aux_batch else ())
                          + problem.shape).astype(np.float32)
    return g, aux


def _plans(problem, mesh, axis_map, par_time, bsize):
    """(distributed, engine, reference) plans of ``problem`` on the CPU."""
    return (plan(problem, RunConfig(backend="distributed", mesh=mesh,
                                    axis_map=axis_map, par_time=par_time,
                                    bsize=bsize, device="cpu")),
            plan(problem, RunConfig(backend="engine", par_time=par_time,
                                    bsize=bsize, device="cpu")),
            plan(problem, RunConfig(backend="reference", device="cpu")))


def _tol(problem, iters):
    return precision.tolerance(problem.dtype, iters, problem.n_stages,
                               scale=100 if problem.needs_aux else None)


#: (program, dims, boundary, mesh shape, axis_map, par_time, bsize, iters,
#: dtype)
CASES = [
    ("diffusion2d", (16, 32), "clamp", (2,), (("a",), None), 2, 16, 5,
     "float32"),
    ("diffusion2d", (16, 32), "reflect", (2,), (None, ("a",)), 2, 16, 5,
     "float32"),
    ("diffusion2d", (16, 32), "constant:0.7", (4,), (("a",), None), 1, 16, 3,
     "float32"),
    ("diffusion2d", (16, 32), ("periodic", "clamp"), (2, 2),
     (("a", "b"), None), 2, 16, 5, "float32"),
    (_star2d_r2, (16, 48), "periodic", (4,), (("a",), None), 1, 24, 4,
     "float32"),
    (_star2d_r2, (16, 48), ("reflect", "periodic"), (2,), (None, ("a",)), 2,
     24, 5, "float32"),
    ("hotspot2d", (16, 32), ("constant:80.0", "reflect"), (4,),
     (("a",), None), 2, 16, 5, "float32"),
    ("diffusion3d", (8, 24, 24), ("clamp", "periodic", "reflect"), (2, 2),
     (("a",), ("b",), None), 2, (8, 8), 5, "float32"),
    ("hotspot3d", (8, 24, 24), ("reflect", "constant:1.0", "clamp"), (2, 2),
     (("a",), ("b",), None), 2, (8, 8), 7, "float32"),
    ("diffusion3d", (8, 24, 24), "periodic", (2, 2), (None, ("a",), ("b",)),
     2, (12, 12), 4, "float32"),
    (_star3d_r2, (8, 24, 24), ("periodic", "reflect", "periodic"), (2,),
     (("a",), None, None), 1, (12, 12), 3, "float32"),
    (_chain, (24, 40), "clamp", (2,), (("a",), None), 2, 16, 5, "float32"),
    (_wave, (32, 24), "periodic", (4,), (("a",), None), 2, 12, 5, "float32"),
    (_diamond, (32, 24), ("clamp", "reflect"), (2, 2), (("a",), ("b",)), 2,
     12, 5, "float32"),
    ("diffusion2d", (16, 32), "reflect", (2, 2), (("a",), ("b",)), 2, 16, 5,
     "bfloat16"),
    (_wave, (32, 24), "constant:0.25", (2,), (None, ("a",)), 2, 12, 3,
     "bfloat16"),
]


def _problem(build, dims, bc, dtype="float32"):
    program = build() if callable(build) else build
    return StencilProblem(program, dims, boundary=bc, dtype=dtype)


@pytest.mark.parametrize(
    "build,dims,bc,mshape,axis_map,par_time,bsize,iters,dtype", CASES)
def test_distributed_equals_engine_and_oracle(build, dims, bc, mshape,
                                              axis_map, par_time, bsize,
                                              iters, dtype):
    prob = _problem(build, dims, bc, dtype)
    axes = ("a", "b")[:len(mshape)]
    dist, eng, ref = _plans(prob, cpu_mesh(mshape, axes), axis_map, par_time,
                            bsize)
    g, aux = _data(prob)
    got = dist.run(g, iters, aux=aux)
    assert got.dtype == prob.torch_dtype and got.device == CPU
    assert torch.equal(got, eng.run(g, iters, aux=aux))
    np.testing.assert_allclose(got.double().numpy(),
                               ref.run(g, iters, aux=aux).double().numpy(),
                               **_tol(prob, iters))


def test_iters_zero_and_partial_super_steps():
    prob = StencilProblem("hotspot2d", (16, 32), boundary="reflect")
    dist, eng, _ = _plans(prob, cpu_mesh((2, 2), ("a", "b")),
                          (("a",), ("b",)), 3, 16)
    g, aux = _data(prob, seed=1)
    assert torch.equal(dist.run(g, 0, aux=aux), torch.from_numpy(g))
    for iters in (1, 2, 4, 7):
        assert torch.equal(dist.run(g, iters, aux=aux),
                           eng.run(g, iters, aux=aux))


@pytest.mark.parametrize("aux_batch", [False, True])
def test_run_batch_one_exchange_per_axis_for_the_batch(aux_batch):
    """A batch of 3 makes the exchanges of one grid: ``ceil(iters/T)`` per
    sharded axis, plus one per axis a run for the aux grid, shared or one
    per member; bit for bit the engine's ``run_batch``."""
    prob = StencilProblem("hotspot3d", (8, 24, 24),
                          boundary=("periodic", "reflect", "clamp"))
    dist, eng, _ = _plans(prob, cpu_mesh((2, 2), ("a", "b")),
                          (("a",), ("b",), None), 2, (8, 8))
    g, aux = _data(prob, batch=3, aux_batch=aux_batch)
    distributed.reset_exchange_counts()
    got = dist.run_batch(g, 7, aux=aux)
    assert distributed.EXCHANGES["state"] == 4 * 2
    assert distributed.EXCHANGES["aux"] == 2
    assert torch.equal(got, eng.run_batch(g, 7, aux=aux))


@pytest.mark.parametrize("build,bc,iters", [
    ("diffusion2d", "clamp", 5), ("diffusion2d", "periodic", 4),
    (_diamond, "reflect", 5), (_wave, "periodic", 3)])
def test_exchange_counts_and_bytes(build, bc, iters):
    """``ceil(iters/T)`` exchanges of the one sharded axis, each handing
    every neighbour a strip ``rad * T`` rows deep of every field: ``rad``
    the DAG's critical path (the diamond's 1, not its summed 2), and on a
    periodic axis the ring's wrap too."""
    prob = _problem(build, (32, 24), bc)
    n, T = 4, 2
    dist, eng, _ = _plans(prob, cpu_mesh((n,), ("a",)), (("a",), None), T,
                          12)
    g, _ = _data(prob)
    distributed.reset_exchange_counts()
    got = dist.run(g, iters)
    supers = -(-iters // T)
    strips = 2 * n if bc == "periodic" else 2 * (n - 1)
    F = len(prob.fields)
    h = prob.stencil.radius * T      # the DAGs' critical-path radius
    assert h == 2
    assert distributed.EXCHANGES["state"] == supers
    assert distributed.EXCHANGES["aux"] == 0
    assert distributed.EXCHANGES["state_bytes"] == \
        supers * strips * F * h * 24 * 4
    assert torch.equal(got, eng.run(g, iters))


def test_halo_is_the_critical_path():
    """The diamond's exchange is its critical-path radius times T (1 x 2),
    not its summed radius (2 x 2): with 2-row shards it plans and runs."""
    prob = _problem(_diamond, (8, 24), "clamp")
    assert distributed.halo_width(None, 2, dag=prob.exec_dag) == 2
    assert sum(s.stencil.radius for s in prob.stages) * 2 == 4
    dist, eng, ref = _plans(prob, cpu_mesh((4,), ("a",)), None, 2, 12)
    g, _ = _data(prob)
    assert torch.equal(dist.run(g, 5), eng.run(g, 5))


def test_exchange_fault_point():
    assert "distributed.exchange" in registered_points()
    prob = StencilProblem("diffusion2d", (16, 32))
    dist, _, _ = _plans(prob, cpu_mesh((2,), ("a",)), None, 2, 16)
    g, _ = _data(prob)
    with FaultPlan([FaultSpec("distributed.exchange", nth=2)]).active():
        with pytest.raises(InjectedFault):
            dist.run(g, 5)
    assert torch.equal(dist.run(g, 5), _plans(
        prob, cpu_mesh((2,), ("a",)), None, 2, 16)[1].run(g, 5))


def test_plan_time_refusals():
    """What the mesh cannot split raises at ``plan()``, before any run."""
    mesh2 = cpu_mesh((2,), ("d",))

    def dist(shape, mesh=mesh2, axis_map=None, **kw):
        kw.setdefault("par_time", 1)
        kw.setdefault("bsize", 16)
        return plan(StencilProblem("diffusion2d", shape, boundary="periodic"),
                    RunConfig(backend="distributed", mesh=mesh,
                              axis_map=axis_map, device="cpu", **kw))
    with pytest.raises(ValueError, match="not divisible"):
        dist((17, 32), axis_map=(("d",), None))
    with pytest.raises(ValueError, match="not divisible"):
        dist((16, 33), axis_map=(None, "d"))
    with pytest.raises(ValueError, match="narrower than the halo"):
        dist((8, 32), mesh=cpu_mesh((4,), ("d",)), par_time=4)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        dist((16, 32), axis_map=(("x",), None))
    with pytest.raises(ValueError, match="one entry per grid axis"):
        dist((16, 32), axis_map=(("d",),))
    with pytest.raises(ValueError, match="needs config.mesh"):
        dist((16, 32), mesh=None)
    with pytest.raises(ValueError, match="par_vec=4 .* row a tick"):
        dist((16, 32), par_vec=4)
    with pytest.raises(ValueError, match="two grid axes over one mesh"):
        dist((16, 32), axis_map=("d", "d"))
    assert dist((16, 32), axis_map=("d", None)).config.axis_map == \
        (("d",), None)


def test_mesh():
    m = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    assert m.devices.shape == (2, 2) and m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 2}
    assert m.distinct_devices == (CPU,) and m.device_type == "cpu"
    assert dp_axes(m) == ("data",)
    assert dp_axes(make_mesh((1, 2, 2), ("pod", "data", "model"),
                             ["cpu"] * 4)) == ("pod", "data")
    with pytest.raises(ValueError, match="of one type"):
        make_mesh((2,), ("d",), [CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("a", "b"), [CPU] * 3)
    with pytest.raises(ValueError, match="repeat"):
        Mesh(np.array([[CPU, CPU]], dtype=object), ("a", "a"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((4,), ("d",))


def test_replicated_mesh_axis_computes_each_shard_once():
    """A mesh axis no grid axis names replicates the shards along it."""
    mesh = cpu_mesh((2, 2), ("a", "b"))
    layout = distributed.shard_layout((16, 32), (("a",), None), mesh)
    assert sorted(layout.devices) == [(0, 0), (1, 0)]
    assert layout.local == (8, 32) and layout.counts == (2, 1)
    prob = StencilProblem("diffusion2d", (16, 32))
    dist, eng, _ = _plans(prob, mesh, (("a",), None), 2, 16)
    g, _ = _data(prob)
    assert torch.equal(dist.run(g, 5), eng.run(g, 5))


def test_distributed_run_entry():
    st = stencils.STENCILS["hotspot2d"]
    g, aux = _data(StencilProblem("hotspot2d", (16, 32)))
    c = stencils.default_coeffs(st)
    got = distributed.distributed_run(
        st, torch.from_numpy(g), c, 5, 2, 16, cpu_mesh((2, 2), ("a", "b")),
        (("a",), ("b",)), torch.from_numpy(aux))
    prob = StencilProblem("hotspot2d", (16, 32))
    want = plan(prob, RunConfig(backend="engine", par_time=2, bsize=16,
                                device="cpu")).run(g, 5, aux=aux)
    assert torch.equal(got, want)


def test_model_prices_shards_on_one_card_and_on_many():
    """``plan()`` hands the model the mesh's shards; logical shards that
    share a card run one after another there and exchange in its device
    memory, shards on distinct cards at once over ``link_bw``."""
    prob = StencilProblem("diffusion2d", (4096, 4096))
    p = plan(prob, RunConfig(backend="distributed", par_time=4, bsize=256,
                             device="cpu",
                             mesh=cpu_mesh((2, 2), ("a", "b")),
                             axis_map=(("a",), ("b",))))
    assert (p.chips.n_chips, p.chips.chip_grid, p.chips.n_cards) == \
        (4, (2, 2), 1)
    assert "mesh: 4 shards, chip_grid=(2, 2), on 1 device(s)" in \
        p.describe()
    one = p.predicted()
    many = perf_model.predict(prob.stencil, prob.shape, 100, (256,), 4,
                              n_chips=4, chip_grid=(2, 2), n_cards=4)
    single = perf_model.predict(prob.stencil, (2048, 2048), 100, (256,), 4)
    dev = perf_model.H100_SXM
    assert many.t_halo == pytest.approx(one.t_halo * dev.mem_bw
                                        / (4 * 2 * dev.link_bw))
    assert one.run_time > 4 * single.run_time > many.run_time
    tuned = plan(prob, RunConfig(backend="distributed", device="cpu",
                                 mesh=cpu_mesh((4,), ("a",))))
    assert tuned.candidates and all(c.geom.par_vec == 1
                                    for c in tuned.candidates)


def test_matches_reference_distributed_on_four_devices():
    """Nine cases against ``repro``'s ``distributed`` on 4 fake devices
    (2×2 with corners, joint mesh axes, 3D, a chain, the periodic wave,
    the diamond, bf16, a batch), in a subprocess."""
    script = os.path.join(os.path.dirname(__file__),
                          "torch_distributed_check.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    out = subprocess.run([sys.executable, script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ALL OK" in out.stdout
