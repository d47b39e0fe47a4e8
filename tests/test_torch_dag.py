"""The port's stage DAGs and periodic boundaries on the ``hopper`` backend
against the reference package on the same numpy inputs: the plain version
of the kernel's DAG body against ``repro``'s ``pallas_interpret`` backend
and ``oracle_dag_run`` (the DAG cases of ``tests/test_programs.py`` that
run clamp and periodic, the wave equation in 2D and 3D, a Hotspot stage
with its aux, eight seeded random DAGs; eight more whose stages differ in
boundary), one super-step against ``repro``'s ``superstep_dag(...,
interpret=True)``, periodic main-path stencils and chains, the run forms,
the traffic report and the plan-time refusals.
Tolerances are ``repro.core.precision.tolerance(..., stages=S)``."""
import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import api as japi
from repro import programs as jprograms
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro.kernels import builder as jbuilder
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import programs
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, stencils
from repro_torch.kernels import builder, ops

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (jprograms.StencilStage, jprograms.StencilProgram,
                  jstencils),
        "port": (StencilStage, StencilProgram, stencils)}


def _wave(nd, c2=0.1):
    """The second-order wave equation of ``examples/wave2d_program.py``
    in ``nd`` dimensions: a star Laplacian of ``u`` fanned with ``u`` and
    ``u_prev`` into a 3-way combine, both fields rotated."""
    def build(S, P, st):
        lap = {"c0": -2.0 * nd}
        lap.update({f"c_{a}_{d}": 1.0 for a in range(nd) for d in (-1, 1)})
        return P((S(st.make_star(nd, 1), coeffs=lap, name="lapu",
                    inputs=("u",)),
                  S(st.make_combine(nd, 3), name="unext",
                    inputs=("u", "u_prev", "lapu"),
                    coeffs={"w0": 2.0, "w1": -1.0, "w2": c2})),
                 fields=("u", "u_prev"),
                 updates={"u": "unext", "u_prev": "u"})
    return build


def _residual(S, P, st):
    return P((S("diffusion2d", name="Au", inputs=("u",)),
              S(st.make_combine(2, 2), name="resid", inputs=("u", "Au"),
                coeffs={"w0": 1.0, "w1": -1.0})))


def _diamond(S, P, st):
    s = st.make_star(2, 1)
    return P((S(s, name="a", inputs=("u",)),
              S(s, name="b", inputs=("u",),
                coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


def _hotspot_dag(S, P, st):
    """A Hotspot stage and its aux, blended with the raw field and a
    second field that trails the first."""
    return P((S("hotspot2d", name="h", inputs=("u",)),
              S(st.make_combine(2, 3), name="m", inputs=("h", "u", "v"),
                coeffs={"w0": 0.5, "w1": 0.3, "w2": 0.2})),
             fields=("u", "v"), updates={"u": "m", "v": "u"})


def _wave_mixed(S, P, st):
    """The 2D wave equation with a reflect Laplacian and a constant 0.5
    combine: stages that differ in boundary (ROADMAP B1k)."""
    lapu, unext = _wave(2)(S, P, st).stages
    return P((dataclasses.replace(lapu, boundary="reflect"),
              dataclasses.replace(unext, boundary="constant:0.5")),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


#: id -> (builder, dims, boundary, par_time, bsize, iters): the clamp and
#: periodic cases of tests/test_programs.py::_DAG_CASES at V=1, the wave
#: equation clamped in 2D and 3D, a Hotspot DAG, the wave equation whose
#: stages differ in boundary
CASES = {
    "wave2d_periodic": (_wave(2), (22, 19), "periodic", 2, 8, 5),
    "residual_clamp": (_residual, (20, 16), "clamp", 2, 8, 3),
    "diamond_periodic_clamp": (_diamond, (24, 15), ("periodic", "clamp"), 2,
                               8, 5),
    "wave2d_clamp": (_wave(2), (21, 26), "clamp", 3, 12, 7),
    "wave3d": (_wave(3), (11, 14, 13), "clamp", 2, 8, 5),
    "wave3d_periodic": (_wave(3), (10, 13, 12), "periodic", 2, 8, 3),
    "hotspot_dag": (_hotspot_dag, (17, 23), "clamp", 2, 8, 5),
    "wave2d_mixed": (_wave_mixed, (21, 26), "clamp", 3, 12, 7),
}


def _problems(build, dims, bc):
    return [mod(build(*PKGS[pkg]), dims, boundary=bc)
            for pkg, mod in (("port", StencilProblem),
                             ("repro", japi.StencilProblem))]


def _data(problem, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.uniform(0.0, 0.1, problem.shape).astype(np.float32)
    return g, aux


def _tol(problem, iters):
    return jprecision.tolerance("float32", iters, stages=problem.n_stages,
                                scale=100 if problem.needs_aux else None)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _check_hopper(mine, want, par_time, bsize, iters, seed):
    """The hopper backend's plain version against pallas_interpret and the
    DAG oracle."""
    g, aux = _data(mine, seed)
    got = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                               bsize=bsize, device="cpu")).run(
                                   g, iters, aux=aux)
    assert tuple(got.shape) == mine.state_shape
    assert got.dtype == torch.float32
    pallas = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=1)).run(jnp.asarray(g), iters, aux=_j(aux))
    conf.assert_close(got, pallas, _tol(mine, iters))
    oracle = jref.oracle_dag_run(
        want.exec_dag, jnp.asarray(g),
        want.resolve_coeffs(dtype=jnp.float32), iters, _j(aux))
    conf.assert_close(got, oracle, _tol(mine, iters))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hopper_dag_matches_pallas_interpret_and_oracle(name):
    """Iteration counts are not multiples of ``par_time``, so the last
    super-step forwards through the state nodes."""
    build, dims, bc, par_time, bsize, iters = CASES[name]
    mine, want = _problems(build, dims, bc)
    assert mine.is_dag and iters % par_time
    _check_hopper(mine, want, par_time, bsize, iters, seed=1)


def _draw_dag(rng, S, P, st):
    """A random valid 2D DAG drawn as in tests/test_programs.py
    (``_draw_dag_case``), every stage feeding something, every field
    updating; boundaries clamp or periodic per axis."""
    n_fields = rng.choice([1, 2])
    fields = tuple(f"f{i}" for i in range(n_fields))
    stages, names = [], []
    for i in range(rng.randint(1, 3)):
        pool = list(fields) + names
        if rng.choice([1, 1, 2]) == 1:
            stc = st.make_star(2, rng.choice([0, 1, 2]))
            ins = (rng.choice(pool),)
        else:
            stc = st.make_combine(2, 2)
            ins = (rng.choice(pool), rng.choice(pool))
        names.append(f"s{i}")
        stages.append(S(stc, name=f"s{i}", inputs=ins))
    consumed = {n for s in stages if s.inputs for n in s.inputs}
    tail = [n for n in names if n not in consumed] + [fields[0]]
    if len(tail) == 1:
        stages.append(S(st.make_star(2, 1), name="out", inputs=(tail[0],)))
    else:
        stages.append(S(st.make_combine(2, len(tail)), name="out",
                        inputs=tuple(tail)))
    updates = {fields[0]: "out"}
    for k in range(1, n_fields):
        updates[fields[k]] = fields[k - 1]
    return P(tuple(stages), fields=fields, updates=updates)


def _random_case(i):
    """(port program, repro program, bc, par_time, seed), both programs
    drawn from the same seed."""
    progs = [_draw_dag(random.Random(3000 + i), *PKGS[pkg])
             for pkg in ("port", "repro")]
    rng = random.Random(4000 + i)
    bc = tuple("periodic" if rng.random() < 0.4 else "clamp"
               for _ in range(2))
    return (*progs, bc, rng.randint(1, 2), rng.randint(0, 10_000))


@pytest.mark.parametrize("i", range(8), ids=lambda i: f"dag{i}")
def test_hopper_random_dag_matches_pallas_interpret_and_oracle(i):
    prog, jprog, bc, par_time, seed = _random_case(i)
    rad = max(1, sum(s.stencil.radius for s in prog.stages))
    dims = (3 * rad * par_time + 5, 13)
    mine = StencilProblem(prog, dims, boundary=bc)
    want = japi.StencilProblem(jprog, dims, boundary=bc)
    assert [s.name for s in mine.stages] == [s.name for s in want.stages]
    _check_hopper(mine, want, par_time, max(2 * rad * par_time + 4, 16),
                  2 * par_time + 1, seed)


def _random_mixed_case(i):
    """(port program, repro program, par_time, seed): a random DAG of
    :func:`_draw_dag` with a random non-periodic boundary per stage (per
    axis clamp, reflect or constant, one fill per stage), so that its
    stages differ in boundary (ROADMAP B1k)."""
    rng = random.Random(6000 + i)
    out = []
    for pkg in ("port", "repro"):
        S, P, st = PKGS[pkg]
        prog = _draw_dag(random.Random(5000 + i), S, P, st)
        draw = random.Random(7000 + i)
        bcs = []
        for _ in prog.stages:
            fill = draw.choice(["0.0", "0.5", "1.5"])
            bcs.append(tuple(
                k if k != "constant" else f"constant:{fill}"
                for k in (draw.choice(["clamp", "reflect", "constant"])
                          for _ in range(2))))
        out.append(P(tuple(dataclasses.replace(s, boundary=bc)
                           for s, bc in zip(prog.stages, bcs)),
                     fields=prog.fields, updates=prog.updates))
    return (*out, rng.randint(1, 2), rng.randint(0, 10_000))


@pytest.mark.parametrize("i", range(8), ids=lambda i: f"dag{i}")
def test_hopper_random_mixed_boundary_dag_matches_pallas_interpret(i):
    """Random DAGs whose stages differ in boundary: every consumer
    re-imposes what it reads under its own boundary (ROADMAP B1k)."""
    prog, jprog, par_time, seed = _random_mixed_case(i)
    rad = max(1, sum(s.stencil.radius for s in prog.stages))
    dims = (3 * rad * par_time + 5, 13)
    mine = StencilProblem(prog, dims)
    want = japi.StencilProblem(jprog, dims)
    assert [s.boundary.token() for s in mine.stages] == [
        s.boundary.token() for s in want.stages]
    _check_hopper(mine, want, par_time, max(2 * rad * par_time + 4, 16),
                  2 * par_time + 1, seed)


@pytest.mark.parametrize("name", ["wave2d_periodic", "diamond_periodic_clamp",
                                  "hotspot_dag", "wave3d_periodic",
                                  "wave2d_mixed"])
def test_plain_dag_superstep_matches_pallas_interpret(name):
    """``superstep_dag_plain`` against ``repro``'s ``superstep_dag(...,
    interpret=True)`` on the same padded ``(F, ns, *padded)`` input, on
    the grid's cells, with ``steps = par_time`` and ``par_time - 1``."""
    build, dims, bc, par_time, bsize, _ = CASES[name]
    mine, want = _problems(build, dims, bc)
    geom = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize, device="cpu")).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=1)).geometry
    bc0 = mine.structural_bc
    g, aux = _data(mine, seed=2)
    gp = ops._pad_blocked(torch.from_numpy(g), geom, bc0)
    jgp = jops._pad_blocked(jnp.asarray(g), jgeom, want.structural_bc)
    assert tuple(gp.shape) == tuple(jgp.shape)
    aux_p = jaux_p = None
    if aux is not None:
        aux_p = ops._pad_blocked(torch.from_numpy(aux), geom, bc0)
        jaux_p = jops._pad_blocked(jnp.asarray(aux), jgeom,
                                   want.structural_bc)
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    ext = blocking.stream_extension(geom, bc0)
    h = geom.size_halo
    cells = ((Ellipsis, slice(ext, ext + dims[0]))
             + tuple(slice(h, h + d) for d in dims[1:]))
    for steps in (par_time, par_time - 1):
        got = builder.superstep_dag_plain(mine.exec_dag, geom, gp, c, steps,
                                          aux_p, torch.empty_like(gp))
        exp = jbuilder.superstep_dag(
            want.exec_dag, jgeom, jgp, jc, jnp.asarray(steps, jnp.int32),
            jaux_p, interpret=True)
        conf.assert_close(got[cells], np.asarray(exp)[cells],
                          _tol(mine, steps))


# --- periodic boundaries on the main path and the chain body -----------------

def _advect_periodic(S, P, st):
    """The upwind-biased star of examples/wave2d_periodic.py."""
    k, drift = 0.1, 0.35
    return [S(st.make_star(2, 1), coeffs={
        "c0": 1.0 - 4 * k, "c_0_-1": k, "c_0_1": k,
        "c_1_-1": k + drift / 2, "c_1_1": k - drift / 2})]


#: id -> (stages builder, dims, boundary, par_time, bsize)
PERIODIC = {
    "diffusion2d": (lambda S, P, st: [S("diffusion2d")], (19, 37),
                    "periodic", 3, 16),
    "hotspot3d": (lambda S, P, st: [S("hotspot3d")], (9, 14, 13),
                  "periodic", 2, (8, 12)),
    "wave2d_periodic_star": (_advect_periodic, (21, 30), "periodic", 2, 12),
    "chain_clamp_periodic": (lambda S, P, st: [S(st.make_star(2, 1)),
                                               S("diffusion2d")],
                             (22, 29), ("clamp", "periodic"), 2, 12),
}


@pytest.mark.parametrize("name", sorted(PERIODIC))
def test_hopper_periodic_matches_pallas_interpret(name):
    build, dims, bc, par_time, bsize = PERIODIC[name]
    mine, want = _problems(build, dims, bc)
    iters = 2 * par_time + 1
    g, aux = _data(mine, seed=5)
    got = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                               bsize=bsize, device="cpu")).run(
                                   g, iters, aux=aux)
    pallas = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=1)).run(jnp.asarray(g), iters, aux=_j(aux))
    conf.assert_close(got, pallas, _tol(mine, iters))


# --- run forms and traffic ---------------------------------------------------

def test_run_batch_of_a_dag_equals_sequential_runs():
    mine, _ = _problems(_wave(2), (18, 16), "periodic")
    p = plan(mine, RunConfig(backend="hopper", par_time=2, bsize=8,
                             device="cpu"))
    g, _ = _data(mine, seed=6)
    batch = np.stack([g, g * 0.5, g + 0.1])
    got = p.run_batch(batch, 3)
    assert tuple(got.shape) == (3,) + mine.state_shape
    for b in range(3):
        assert torch.equal(got[b], p.run(batch[b], 3))
    with pytest.raises(ValueError, match="shape"):
        p.run(g[0], 1)            # the state without its field axis


@pytest.mark.parametrize("name", ["wave2d_periodic", "diamond_periodic_clamp",
                                  "hotspot_dag"])
def test_traffic_report_prices_the_dag_rings(name):
    """``smem_bytes`` is the layout's rings, one per value an entry reads;
    the traffic report gives it with the fields and streams, and the
    device-memory bytes of ``repro``'s report."""
    build, dims, bc, par_time, bsize, iters = CASES[name]
    mine, want = _problems(build, dims, bc)
    p = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                             bsize=bsize, device="cpu"))
    lay = programs.dag_layout(programs.unroll_dag(mine.exec_dag, par_time), 1)
    jlay = jprograms.dag_layout(jprograms.unroll_dag(want.exec_dag,
                                                     par_time), 1)
    assert (lay.lags, lay.wins, lay.out_lag) == (jlay.lags, jlay.wins,
                                                 jlay.out_lag)
    rings = sum(lay.wins) * int(np.prod(p.geometry.bsize)) * 4
    assert blocking.smem_bytes(p.geometry, mine.exec_dag) == rings
    tr = p.traffic_report(iters)
    F = len(mine.fields)
    assert tr["smem_bytes"] == rings
    assert tr["fields"] == list(mine.fields)
    assert (tr["streams_in"], tr["streams_out"]) == (
        F + int(mine.needs_aux), F)
    jtr = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=1)).traffic_report(iters)
    for k in ("model_bytes_per_superstep", "kernel_dma_bytes_per_superstep",
              "n_super", "stages"):
        assert tr[k] == jtr[k], k


def test_dag_table_follows_the_layout():
    """The kernel's entry table for the wave equation: per entry its lag,
    every input's ring, its own ring and the field it drains to; per field
    stream its ring."""
    mine, _ = _problems(_wave(2), (16, 40), "periodic")
    T = 3
    geom = plan(mine, RunConfig(backend="hopper", par_time=T, bsize=16,
                                device="cpu")).geometry
    dag = mine.exec_dag
    up = programs.unroll_dag(dag, T)
    lay = programs.dag_layout(up, 1)
    c = ops.pack_dag_coeffs(dag, mine.resolve_coeffs())
    table, out_lag, n = builder._dag_table(dag, geom, c)
    assert (n, out_lag) == (len(up.entries), lay.out_lag)
    base = builder._ring_bases(lay.wins)
    for f in range(2):
        assert (table.f[f].base, table.f[f].slots) == (base[f], lay.wins[f])
        assert table.f[f].out == 0
    for i, e in enumerate(up.entries):
        v = 2 + i
        row = table.e[i]
        assert (row.lag, row.iteration, row.n_in) == (
            lay.lags[v], e.iteration, len(e.inputs))
        assert (row.stage == -1) == (e.stencil is None)
        assert [(row.in_base[z], row.in_slots[z])
                for z in range(len(e.inputs))] == [
            (base[p], lay.wins[p]) for p in e.inputs]
        assert row.out_slots == lay.wins[v]
        assert row.field == (up.outputs.index(v) if v in up.outputs else -1)


# --- refusals ----------------------------------------------------------------

def _hopper(problem, **cfg):
    cfg.setdefault("par_time", 2)
    cfg.setdefault("bsize", 16)
    return plan(problem, RunConfig(backend="hopper", device="cpu", **cfg))


def test_hopper_dag_refusals_name_their_item():
    S, P, st = PKGS["port"]
    wave = _wave(2)(S, P, st)
    # one boundary on every stage plans (B1c), and so do stages that
    # differ (B1k): the reflect combine agrees with pallas_interpret
    for bc in ("constant:0.5", ("clamp", "reflect")):
        assert _hopper(StencilProblem(wave, (16, 32), boundary=bc)).geometry

    def mixed(S, P, st):
        lapu, unext = _wave(2)(S, P, st).stages
        return P((lapu, dataclasses.replace(unext, boundary="reflect")),
                 fields=("u", "u_prev"),
                 updates={"u": "unext", "u_prev": "u"})
    mine, want = _problems(mixed, (16, 32), "clamp")
    _check_hopper(mine, want, 2, 16, 5, seed=9)
    # a custom stage in a DAG agrees with pallas_interpret (ROADMAP B1i);
    # an op the tracer does not lower is refused (B1i-ops)
    def custom_dag(apply):
        def build(S, P, st):
            custom = st.Stencil("custom2d", 2, 1, 3, 1, 1, False, ("a",),
                                apply)
            return P((S(custom, name="a", inputs=("u",), coeffs={"a": 0.9}),
                      S(st.make_combine(2, 2), name="m",
                        inputs=("u", "a"))),
                     fields=("u",))
        return build
    mine, want = _problems(custom_dag(
        lambda get, c, aux=None: c["a"] * get((0, 1))), (16, 32), "clamp")
    _check_hopper(mine, want, 2, 16, 5, seed=10)
    with pytest.raises(ValueError, match="B1i-ops"):
        _hopper(StencilProblem(custom_dag(
            lambda get, c, aux=None: torch.erf(get((0, 1))))(
                *PKGS["port"]), (16, 32)))
    five = tuple(f"f{i}" for i in range(5))

    def five_fields(S, P, st):
        return P((S(st.make_star(2, 1), name="a", inputs=("f0",)),),
                 fields=five,
                 updates={"f0": "a", **{five[i]: five[i - 1]
                                        for i in range(1, 5)}})

    def five_inputs(S, P, st):
        return P((S(st.make_star(2, 1), name="a", inputs=("u",)),
                  S(st.make_combine(2, 5), name="m",
                    inputs=("u", "a", "a", "u", "a"))),)
    # five field streams, and five inputs to one stage, past the kernel
    # parameter's table of 4, take the large-table route (ROADMAP B1j) and
    # agree with pallas_interpret
    for build, seed in ((five_fields, 12), (five_inputs, 13)):
        mine, want = _problems(build, (16, 32), "clamp")
        assert builder.tables_of(_hopper(mine).geometry,
                                 mine.exec_dag).big
        _check_hopper(mine, want, 2, 16, 5, seed=seed)
    # 80 fused entries, past the kernel parameter's table of 64, take the
    # large-table route (ROADMAP B1j) and agree with pallas_interpret
    mine, want = _problems(_wave(2), (16, 128), "clamp")
    assert builder.tables_of(_hopper(mine, par_time=20, bsize=96).geometry,
                             mine.exec_dag).entries == 80
    _check_hopper(mine, want, 20, 96, 21, seed=10)
    # the CTA takes a thread per entry however narrow the block, and
    # par_vec > 1 runs (ROADMAP B1d)
    assert _hopper(StencilProblem(wave, (16, 32)), par_time=4,
                   bsize=12).geometry.bsize == (12,)
    assert _hopper(StencilProblem(wave, (16, 32)),
                   par_vec=2).geometry.par_vec == 2
    assert _hopper(StencilProblem(wave, (16, 32),
                                  dtype="bfloat16")).geometry   # B1e


def test_superstep_dag_rejects_bad_inputs():
    S, P, st = PKGS["port"]
    problem = StencilProblem(_wave(2)(S, P, st), (8, 40),
                             boundary="periodic")
    geom = blocking.BlockGeometry(2, (8, 40), 1, 2, (16,))
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    gp = torch.zeros((2, 8 + 4) + geom.padded_dims)
    assert builder.superstep_dag(dag, geom, gp, c, 2).shape == gp.shape
    with pytest.raises(ValueError, match="shape"):   # no stream extension
        builder.superstep_dag(dag, geom, gp[:, 2:-2].contiguous(), c, 2)
    with pytest.raises(ValueError, match="shape"):   # no field axis
        builder.superstep_dag(dag, geom, gp[0], c, 2)
    with pytest.raises(ValueError, match="steps"):
        builder.superstep_dag(dag, geom, gp, c, 3)
    with pytest.raises(ValueError, match="coeffs"):
        builder.superstep_dag(dag, geom, gp, c[1:], 2)
    with pytest.raises(ValueError, match="alias"):
        builder.superstep_dag(dag, geom, gp, c, 2, out=gp)
    with pytest.raises(ValueError, match="no kernel"):
        builder.superstep_dag(dag, geom, gp.to("meta"), c, 2)
