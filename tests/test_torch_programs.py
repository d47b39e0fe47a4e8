"""The port's stage programs against the reference package on the same numpy
inputs: ``StencilStage``/``StencilProgram`` validation and the program forms
of ``StencilProblem``, the program and DAG oracles, the ``hopper`` backend's
plain version of the chain kernel (against ``pallas_interpret`` and
``oracle_program_run``), one super-step of a chain against ``repro``'s
Pallas kernel in interpret mode, fusion, and the plan-time refusals.
Tolerances are ``repro.core.precision.tolerance(..., stages=S)``."""
import dataclasses

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
from repro_torch.kernels import builder, ops, ref

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (jprograms.StencilStage, jprograms.StencilProgram,
                  jstencils),
        "port": (StencilStage, StencilProgram, stencils)}

ADVECT = {"c0": 0.7, "c_0_-1": 0.1, "c_0_1": 0.0, "c_1_-1": 0.2,
          "c_1_1": 0.0}


def _chain(*parts):
    """A program builder ``(Stage, Program, stencils) -> stages``: each part
    is a registered name, or ``(maker, args, stage kwargs)``."""
    def build(S, P, st):
        out = []
        for part in parts:
            if isinstance(part, str):
                out.append(S(part))
            else:
                maker, args, kw = part
                out.append(S(getattr(st, maker)(*args), **kw))
        return out
    return build


def _wave2d(S, P, st):
    return P((S(st.make_star(2, 1), name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond2d(S, P, st):
    s = st.make_star(2, 1)
    return P((S(s, name="a", inputs=("u",)),
              S(s, name="b", inputs=("u",),
                coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


DAMP = ("make_star", (2, 0), {"coeffs": {"c0": 0.95}, "name": "damp"})

#: the chains the hopper backend runs: id -> (builder, dims, par_time, bsize)
CHAINS = {
    "chain2d": (_chain(("make_star", (2, 1), {}), "diffusion2d"),
                (23, 31), 2, 12),
    "chain3d": (_chain(("make_star", (3, 1), {}), "diffusion3d"),
                (9, 14, 13), 2, 12),
    "damp2d": (_chain("diffusion2d", DAMP), (20, 29), 3, 12),
    "diffuse3_2d": (_chain("diffusion2d", "diffusion2d", "diffusion2d"),
                    (17, 32), 2, 16),
    "box2d": (_chain(("make_box", (2, 1), {}), "diffusion2d"), (19, 27), 2,
              12),
    "hotspot_damp2d": (_chain("hotspot2d", DAMP), (21, 30), 3, 12),
    "star_r2_diffuse2d": (_chain(("make_star", (2, 2), {}), "diffusion2d"),
                          (24, 32), 2, 16),
    "advect_diffuse2d": (_chain(("make_star", (2, 1),
                                 {"coeffs": ADVECT, "name": "advect"}),
                                "diffusion2d"), (22, 30), 2, 14),
    # 12 entries on a 12-cell block plane: radius-0 stages add entries but
    # no halo
    "damp2_diffuse2d": (_chain("diffusion2d", DAMP, DAMP), (14, 26), 4, 12),
}


def _problems(build, dims, **kw):
    """(port problem, reference problem) of the same program."""
    out = []
    for pkg, mod in (("port", StencilProblem), ("repro", japi.StencilProblem)):
        out.append(mod(build(*PKGS[pkg]), dims, **kw))
    return out


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


# --- validation: every malformed program raises in both packages ------------

def _cycle(S, P, st):
    s = st.make_star(2, 1)
    P((S(s, name="a", inputs=("b",)), S(s, name="b", inputs=("a",))))


def _dangling(S, P, st):
    P((S(st.make_star(2, 1), name="a", inputs=("nope",)),))


def _arity(S, P, st):
    S(st.make_combine(2, 2), name="m", inputs=("u",))


def _unused(S, P, st):
    s = st.make_star(2, 1)
    P((S(s, name="dead", inputs=("u",)), S(s, name="live", inputs=("u",))),
      updates={"u": "live"})


def _bad_update(S, P, st):
    P((S(st.make_star(2, 1), name="a", inputs=("u",)),),
      updates={"u": "ghost"})


def _unnamed_fan_in(S, P, st):
    P((S(st.make_star(2, 1)), S(st.make_combine(2, 2))))


def _mixed_periodicity(S, P, st):
    s = st.make_star(2, 1)
    prog = P((S(s, name="a", inputs=("u",), boundary=("periodic", "clamp")),
              S(s, name="b", inputs=("u",), boundary="clamp"),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"))))
    prog.resolved("clamp", (16, 16))


INVALID = [(_cycle, "[Cc]ycle"), (_dangling, "nope"),
           (_arity, "arity|inputs"), (_unused, "never consumed"),
           (_bad_update, "ghost"), (_unnamed_fan_in, "inputs"),
           (_mixed_periodicity, "periodic")]


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", INVALID, ids=lambda c: c[0].__name__[1:])
def test_invalid_programs_raise_in_both_packages(case, pkg):
    fn, match = case
    with pytest.raises(ValueError, match=match):
        fn(*PKGS[pkg])


# --- program forms of StencilProblem ----------------------------------------

FORMS = {
    "bare": lambda S, P, st: "diffusion2d",
    "lone_plain_stage": lambda S, P, st: S("diffusion2d"),
    "lone_stage_coeffs": lambda S, P, st: S("diffusion2d",
                                            coeffs={"cc": 0.4}),
    "lone_stage_bc": lambda S, P, st: [S("diffusion2d", boundary="reflect")],
    "chain": CHAINS["advect_diffuse2d"][0],
    "mixed_bc_chain": lambda S, P, st: [
        S(st.make_star(2, 2)),
        S("diffusion2d", boundary=("clamp", "reflect"))],
    "hotspot_damp": CHAINS["hotspot_damp2d"][0],
    "wave2d": _wave2d,
    "diamond2d": _diamond2d,
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_problem_forms_match_reference(form):
    mine, want = _problems(FORMS[form], (16, 20))
    assert type(mine.stencil).__name__ == type(want.stencil).__name__
    assert mine.stencil.name == want.stencil.name
    for prop in ("n_stages", "is_program", "is_dag", "fields", "state_shape",
                 "needs_aux", "ndim"):
        assert getattr(mine, prop) == getattr(want, prop), prop
    for prop in ("radius", "flop_pcu", "num_read", "num_write", "has_aux"):
        assert getattr(mine.stencil, prop) == getattr(want.stencil, prop)
    assert ([(st.name, bc.token()) for st, bc in mine.exec_stages]
            == [(st.name, bc.token()) for st, bc in want.exec_stages])
    assert mine.structural_bc.token() == want.structural_bc.token()
    dag, jdag = mine.exec_dag, want.exec_dag
    assert (dag.n_fields, dag.updates, dag.topo) == (
        jdag.n_fields, jdag.updates, jdag.topo)
    assert ([refs for _, _, refs in dag.stages]
            == [refs for _, _, refs in jdag.stages])
    assert mine.program.stage_radii == want.program.stage_radii
    assert mine.program.inputs_idx == want.program.inputs_idx
    # defaults, stage overrides, and run-time overrides over both
    override = [None] * mine.n_stages
    name0 = mine.stages[0].stencil.coeff_names[0]
    override[0] = {name0: 0.25}
    if mine.n_stages == 1:
        override = override[0]
    for run_c in (None, override):
        got = mine.resolve_coeffs(run_c)
        exp = want.resolve_coeffs(run_c, dtype=jnp.float32)
        assert len(got) == len(exp) == mine.n_stages
        for a, b in zip(got, exp):
            assert sorted(a) == sorted(b)
            for k in a:
                assert float(a[k]) == np.float32(b[k])


def test_resolve_coeffs_rejects_what_the_reference_rejects():
    mine, want = _problems(CHAINS["chain2d"][0], (16, 20))
    for bad in ({"c0": 1.0}, [None], [{"zz": 1.0}, None]):
        with pytest.raises(ValueError):
            mine.resolve_coeffs(bad)
        with pytest.raises(ValueError):
            want.resolve_coeffs(bad)


# --- oracles -----------------------------------------------------------------

ORACLE_CASES = ["chain2d", "hotspot_damp2d", "star_r2_diffuse2d"]


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_oracle_program_run_matches_reference(name):
    build, dims, _, _ = CHAINS[name]
    mine, want = _problems(build, dims)
    g, aux = _data(mine)
    got = ref.oracle_program_run(mine.exec_stages, torch.from_numpy(g),
                                 mine.resolve_coeffs(), 5,
                                 None if aux is None
                                 else torch.from_numpy(aux))
    exp = jref.oracle_program_run(want.exec_stages, jnp.asarray(g),
                                  want.resolve_coeffs(dtype=jnp.float32), 5,
                                  _j(aux))
    conf.assert_close(got, exp, _tol(mine, 5))


@pytest.mark.parametrize("build", [_wave2d, _diamond2d],
                         ids=["wave2d", "diamond2d"])
def test_oracle_dag_run_matches_reference(build):
    mine, want = _problems(build, (18, 22))
    g, _ = _data(mine)
    got = ref.oracle_dag_run(mine.exec_dag, torch.from_numpy(g),
                             mine.resolve_coeffs(), 6)
    exp = jref.oracle_dag_run(want.exec_dag, jnp.asarray(g),
                              want.resolve_coeffs(dtype=jnp.float32), 6)
    assert tuple(got.shape) == mine.state_shape
    conf.assert_close(got, exp, _tol(mine, 6))


@pytest.mark.parametrize("build", [_wave2d, _diamond2d],
                         ids=["wave2d", "diamond2d"])
def test_reference_backend_runs_dags(build):
    """``plan().run()`` on the port's reference backend takes and returns
    the ``(F, *shape)`` field stack, as ``repro``'s does."""
    mine, want = _problems(build, (18, 22))
    g, _ = _data(mine, seed=4)
    got = plan(mine, RunConfig(backend="reference", device="cpu")).run(g, 5)
    exp = japi.plan(want, japi.RunConfig(backend="reference")).run(
        jnp.asarray(g), 5)
    conf.assert_close(got, exp, _tol(mine, 5))


# --- the hopper backend's plain version of the chain kernel -----------------

@pytest.mark.parametrize("name", sorted(CHAINS))
def test_hopper_cpu_matches_pallas_interpret_and_oracle(name):
    """Iteration counts are not multiples of ``par_time``, so the last
    super-step forwards."""
    build, dims, par_time, bsize = CHAINS[name]
    mine, want = _problems(build, dims)
    iters = 2 * par_time + 1
    g, aux = _data(mine, seed=1)
    got = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                               bsize=bsize, device="cpu")).run(
                                   g, iters, aux=aux)
    assert tuple(got.shape) == dims and got.dtype == torch.float32
    pallas = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize)).run(
            jnp.asarray(g), iters, aux=_j(aux))
    conf.assert_close(got, pallas, _tol(mine, iters))
    oracle = jref.oracle_program_run(
        want.exec_stages, jnp.asarray(g),
        want.resolve_coeffs(dtype=jnp.float32), iters, _j(aux))
    conf.assert_close(got, oracle, _tol(mine, iters))


@pytest.mark.parametrize("name", ["star_r2_diffuse2d", "hotspot_damp2d",
                                  "chain3d"])
def test_plain_chain_superstep_matches_pallas_interpret(name):
    """``superstep_plain`` of a chain against ``repro``'s
    ``superstep_chain(..., interpret=True)`` on the same padded input, on
    the compute region, with ``steps = par_time`` and ``steps <
    par_time``."""
    build, dims, par_time, bsize = CHAINS[name]
    mine, want = _problems(build, dims)
    geom = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize, device="cpu")).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time,
        bsize=bsize)).geometry
    g, aux = _data(mine, seed=2)
    gp = ops._pad_blocked(torch.from_numpy(g), geom)
    jgp = jops._pad_blocked(jnp.asarray(g), jgeom)
    aux_p = None if aux is None else ops._pad_blocked(
        torch.from_numpy(aux), geom)
    jaux_p = None if aux is None else jops._pad_blocked(jnp.asarray(aux),
                                                        jgeom)
    c = ops.pack_program_coeffs(mine.exec_stages, mine.resolve_coeffs())
    jc = jops.pack_program_coeffs(want.exec_stages,
                                  want.resolve_coeffs(dtype=jnp.float32))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * cs) for n, cs in
                                    zip(geom.bnum, geom.csize))
    for steps in (par_time, par_time - 1):
        got = builder.superstep_plain(mine.exec_stages, geom, gp, c, steps,
                                      aux_p, torch.empty_like(gp))
        exp = jbuilder.superstep_chain(
            want.exec_stages, jgeom, jgp, jc, jnp.asarray(steps, jnp.int32),
            jaux_p, interpret=True)
        conf.assert_close(got[region], np.asarray(exp)[region],
                          _tol(mine, steps))


def test_pack_dag_coeffs_matches_reference():
    mine, want = _problems(_wave2d, (12, 12))
    np.testing.assert_array_equal(
        ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs()).numpy(),
        np.asarray(jops.pack_dag_coeffs(
            want.exec_dag, want.resolve_coeffs(dtype=jnp.float32))))


@pytest.mark.parametrize("name", ["damp2d", "star_r2_diffuse2d", "chain3d"])
def test_kernel_rings_are_the_layout_windows(name):
    """The chain's unroll layout matches ``repro``'s; ``smem_bytes`` counts
    a ``2R+1``-slot ring per radius-``R`` consumer (1 slot for radius 0)
    and none for the last entry; the kernel's entry table follows the
    layout."""
    build, dims, par_time, bsize = CHAINS[name]
    mine, want = _problems(build, dims)
    lay = programs.dag_layout(programs.unroll_dag(
        programs.chain_dag(mine.exec_stages), par_time), 1)
    jlay = jprograms.dag_layout(jprograms.unroll_dag(
        jprograms.chain_dag(want.exec_stages), par_time), 1)
    assert (lay.radii, lay.lags, lay.wins, lay.out_lag) == (
        jlay.radii, jlay.lags, jlay.wins, jlay.out_lag)
    geom = plan(mine, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize, device="cpu")).geometry
    radii = [st.radius for st, _ in mine.exec_stages] * par_time
    plane = int(np.prod(geom.bsize))
    assert blocking.smem_bytes(geom, mine.exec_stages) == (
        sum(2 * r + 1 for r in radii) * plane * 4)
    c = ops.pack_program_coeffs(mine.exec_stages, mine.resolve_coeffs())
    table, out_lag = builder._program_table(mine.exec_stages, geom, c)
    assert out_lag == geom.size_halo
    lags = np.cumsum(radii)
    for i, r in enumerate(radii):
        e = table.e[i]
        assert (e.lag, e.in_slots[0]) == (lags[i], 2 * r + 1)
        assert e.out_slots == (2 * radii[i + 1] + 1 if i + 1 < len(radii)
                               else 0)
    assert list(table.c)[:c.numel()] == c.tolist()


def test_linear_taps_follow_the_apply_order():
    star, box = stencils.make_star(3, 2), stencils.make_box(2, 1)
    for st in (star, box):
        taps = builder.linear_taps(st)
        assert [st.coeff_names[i] for i, _ in taps] == list(st.coeff_names)
        assert [off for _, off in taps] == list(st.offsets)
        assert builder.stage_op(st) == builder.TAP_OP
    assert builder.linear_taps(stencils.DIFFUSION2D) is None
    assert builder.stage_op(stencils.DIFFUSION2D) == 0
    assert builder.stage_op(stencils.make_combine(2, 2)) == (
        builder.COMBINE_OP)
    custom = stencils.Stencil("custom2d", 2, 0, 1, 1, 1, False, ("a",),
                              lambda get, c, aux=None: c["a"] * get((0, 0)))
    assert builder.linear_taps(custom) is None
    assert builder.stage_op(custom) == builder.CUSTOM_OP


# --- fusion ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chain2d", "damp2d"])
def test_fused_plan_equals_chained_single_stage_plans(name):
    build, dims, _, bsize = CHAINS[name]
    mine, want = _problems(build, dims)
    g, _ = _data(mine, seed=3)
    cfg = dict(backend="hopper", bsize=bsize, device="cpu")
    fused = plan(mine, RunConfig(par_time=2, **cfg))
    singles = [plan(StencilProblem([s], dims), RunConfig(par_time=1, **cfg))
               for s in mine.stages]
    seq = torch.from_numpy(g)
    for _ in range(5):
        for p in singles:
            seq = p.run(seq, 1)
    conf.assert_close(fused.run(g, 5), seq, _tol(mine, 5))
    tr = fused.traffic_report(5)
    jtr = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=2, bsize=bsize)
    ).traffic_report(5)
    assert tr["intermediate_hbm_bytes_per_superstep"] == 0
    assert tr["unfused_intermediate_bytes_per_superstep"] > 0
    for k in ("stages", "unfused_intermediate_bytes_per_superstep",
              "model_bytes_per_superstep", "kernel_dma_bytes_per_superstep",
              "n_super"):
        assert tr[k] == jtr[k], k
    assert tr["smem_bytes"] == blocking.smem_bytes(fused.geometry,
                                                   mine.exec_stages)


# --- refusals ----------------------------------------------------------------

def _hopper(problem, **cfg):
    cfg.setdefault("par_time", 2)
    cfg.setdefault("bsize", 16)
    return plan(problem, RunConfig(backend="hopper", device="cpu", **cfg))


def test_hopper_main_path_par_time_is_bound_by_shared_memory_only():
    """A single Table-2 stage runs the kernel's main-path body, which reads
    no entry table: more fused entries than the chain body's table holds
    still plan and run; a chain of as many entries takes the large-table
    route (ROADMAP B1j) and runs too."""
    problem = StencilProblem("diffusion2d", (6, 400))
    p = _hopper(problem, par_time=80, bsize=170)
    assert builder.kernel_limits(p.geometry, problem.exec_stages) is None
    g, _ = _data(problem, seed=4)
    iters = 83
    want = plan(problem, RunConfig(backend="reference", device="cpu")).run(
        g, iters)
    conf.assert_close(p.run(g, iters), want, _tol(problem, iters))
    S, _, st = PKGS["port"]
    chain = StencilProblem([S("diffusion2d"),
                            S(st.make_star(2, 0), coeffs={"c0": 0.99})],
                           (6, 400))
    p = _hopper(chain, par_time=40, bsize=170)
    tab = builder.tables_of(p.geometry, chain.exec_dag)
    assert tab.entries == 80 and tab.big
    want = plan(chain, RunConfig(backend="reference", device="cpu")).run(
        g, 43)
    conf.assert_close(p.run(g, 43), want, _tol(chain, 43))


def _custom2d(st, apply=None):
    return st.Stencil("custom2d", 2, 1, 3, 1, 1, False, ("a",), apply or (
        lambda get, c, aux=None: c["a"] * get((0, 1))))


def test_hopper_refuses_program_forms_it_does_not_run():
    S, P, st = PKGS["port"]
    # DAGs plan (ROADMAP B1h is ported), with stages that differ in
    # boundary too (B1k), and with a custom stencil (B1i): it agrees with
    # pallas_interpret
    forward_ref = P((S("diffusion2d", name="a", inputs=("b",)),
                     S("diffusion2d", name="b", inputs=("u",))),
                    updates={"u": "a"})
    assert _hopper(StencilProblem(forward_ref, (16, 32))).problem.is_dag

    def custom_dag(S, P, st):
        return P((S(_custom2d(st), name="a", inputs=("u",),
                    coeffs={"a": 0.9}),
                  S(st.make_combine(2, 2), name="m", inputs=("u", "a"))))
    mine, want = _problems(custom_dag, (16, 32))
    g, _ = _data(mine, seed=8)
    conf.assert_close(
        _hopper(mine).run(g, 5),
        japi.plan(want, japi.RunConfig(backend="pallas_interpret",
                                       par_time=2, bsize=16)).run(
                                           jnp.asarray(g), 5),
        _tol(mine, 5))
    with pytest.raises(ValueError, match="B1i-ops"):
        _hopper(StencilProblem(P(
            (S(_custom2d(st, lambda get, c, aux=None: get((0, 2))),
               name="a", inputs=("u",)),
             S(st.make_combine(2, 2), name="m", inputs=("u", "a"))),
        ), (16, 32)))
    def mixed(S, P, st):
        a, b, m = _diamond2d(S, P, st).stages
        return P((a, dataclasses.replace(b, boundary="reflect"), m))
    mine, want = _problems(mixed, (16, 32))
    g, _ = _data(mine, seed=8)
    conf.assert_close(
        _hopper(mine).run(g, 5),
        japi.plan(want, japi.RunConfig(backend="pallas_interpret",
                                       par_time=2, bsize=16)).run(
                                           jnp.asarray(g), 5),
        _tol(mine, 5))
    # one boundary on a DAG, and chains whose stages differ, plan (B1c)
    assert _hopper(StencilProblem(_diamond2d(S, P, st), (16, 32),
                                  boundary=("clamp", "reflect"))).geometry
    assert _hopper(StencilProblem([S("diffusion2d"),
                                   S(st.make_star(2, 1), boundary="reflect")],
                                  (16, 32))).geometry
    # a chain with a custom stage agrees with pallas_interpret too; one
    # whose apply branches on a value is refused
    mine, want = _problems(lambda S, P, st: [
        S("diffusion2d"), S(_custom2d(st), coeffs={"a": 0.9})], (16, 32))
    conf.assert_close(
        _hopper(mine).run(g, 5),
        japi.plan(want, japi.RunConfig(backend="pallas_interpret",
                                       par_time=2, bsize=16)).run(
                                           jnp.asarray(g), 5),
        _tol(mine, 5))
    with pytest.raises(ValueError, match="B1i-ops"):
        _hopper(StencilProblem([S("diffusion2d"), S(_custom2d(
            st, lambda get, c, aux=None: get((0, 0)) if get((0, 1)) > 0
            else get((0, -1))))], (16, 32)))
    with pytest.raises(ValueError, match="shared memory"):
        _hopper(StencilProblem([S(st.make_star(2, 2)), S("diffusion2d")],
                               (8, 9000)), par_time=10, bsize=1000)
    # 65 entries and a 129-tap star, past the kernel parameter's tables,
    # take the large-table route (ROADMAP B1j) and agree with the
    # reference backend
    for stages, T, bsize, dims in (([S(st.make_star(2, 0))] * 5, 13, 16,
                                    (8, 64)),
                                   ([S(st.make_star(2, 32))], 1, 300,
                                    (8, 400))):
        prob = StencilProblem(stages, dims)
        p = _hopper(prob, par_time=T, bsize=bsize)
        assert builder.tables_of(p.geometry, prob.exec_dag).big
        g, _ = _data(prob, seed=11)
        want = plan(prob, RunConfig(backend="reference", device="cpu")).run(
            g, T + 1)
        conf.assert_close(p.run(g, T + 1), want, _tol(prob, T + 1))
    # 12 entries on an 11-cell plane: the CTA takes a thread per entry
    assert _hopper(StencilProblem([S("diffusion2d"), S(st.make_star(2, 0)),
                                   S(st.make_star(2, 0))], (14, 26)),
                   par_time=4, bsize=11).geometry.bsize == (11,)
    # a 343-tap stage takes the large-table route too
    prob = StencilProblem([S(st.make_box(3, 3)), S("diffusion3d")],
                          (8, 30, 30))
    p = _hopper(prob, par_time=1, bsize=(20, 20))
    assert builder.tables_of(p.geometry, prob.exec_dag).big
    g, _ = _data(prob, seed=12)
    want = plan(prob, RunConfig(backend="reference", device="cpu")).run(g, 2)
    conf.assert_close(p.run(g, 2), want, _tol(prob, 2))
    # what the hopper backend refuses, the reference backend runs
    custom = _custom2d(st, lambda get, c, aux=None: c["a"] * torch.erf(
        get((0, 1))))
    with pytest.raises(ValueError, match="B1i-ops"):
        builder.stage_op(custom)
    prob = StencilProblem(P((S(custom, name="a", inputs=("u",),
                               coeffs={"a": 0.5}),
                             S(st.make_combine(2, 2), name="m",
                               inputs=("u", "a")))), (16, 32))
    g, _ = _data(prob)
    out = plan(prob, RunConfig(backend="reference", device="cpu")).run(g, 2)
    assert bool(out.isfinite().all())
