"""Block planes and tables past the Hopper streaming kernel's first caps
(ROADMAP B1j) on the ``hopper`` backend against the reference package on
the same numpy inputs: block planes over 1024 cells (the kernel's wide
form: 2D ``bsize = 2048``, 3D planes of 42 x 42) and programs past the
capacities of the kernel parameter's ``Program`` table (two ``make_box(3,
2)`` stages, 250 taps; 17 stages; 196 coefficients), which take the
large-table route, in float32 and bfloat16, against ``repro``'s
``pallas_interpret`` backend and the ``reference`` backend; one super-step
of the 250-tap chain against ``repro``'s interpret-mode kernel; the CTA
shape of the wide form and the large-table route; the large table's
layout; lags and ring slots past 16 bits; a 343-tap stage and five field
streams; and what is still refused: shared memory.  Tolerances are
``repro.core.precision.tolerance(dtype, iters, stages)``.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro.kernels import builder as jbuilder
from repro.kernels import ops as jops
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, stencils
from repro_torch.kernels import _build, builder, ops

torch.set_num_threads(1)

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (japi.StencilStage, japi.StencilProgram, jstencils),
        "port": (StencilStage, StencilProgram, stencils)}
F32, BF16 = "float32", "bfloat16"


def _single(name):
    return lambda S, P, st: name


def _wave(S, P, st):
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return P((S(st.make_star(2, 1), coeffs=lap, name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _box_chain(S, P, st):
    """Two ``make_box(3, 2)`` stages: 250 taps and 250 coefficients."""
    return [S(st.make_box(3, 2)), S(st.make_box(3, 2))]


def _damp_chain(S, P, st):
    """17 radius-0 stars: one stage past the table's 16."""
    return [S(st.make_star(2, 0), coeffs={"c0": 0.99})] * 17


def _box2d_chain(S, P, st):
    """Four ``make_box(2, 3)`` stages: 196 taps and coefficients, past
    the table's 128 and 192."""
    return [S(st.make_box(2, 3))] * 4


def _problems(build, dims, bc, dtype):
    """(port problem, reference problem) of the same program."""
    return (StencilProblem(build(*PKGS["port"]), dims, boundary=bc,
                           dtype=dtype),
            japi.StencilProblem(build(*PKGS["repro"]), dims, boundary=bc,
                                dtype=dtype))


def _data(problem, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.uniform(0.0, 0.1, problem.shape).astype(np.float32)
    return g, aux


def _t(x, dtype):
    return None if x is None else torch.from_numpy(x).to(
        getattr(torch, dtype))


def _j(x, dtype):
    return None if x is None else jnp.asarray(x, getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _tol(problem, iters):
    return jprecision.tolerance(problem.dtype, iters,
                                stages=problem.n_stages,
                                scale=100 if problem.needs_aux else None)


def _hopper(problem, par_time, bsize, V=1):
    return plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V, device="cpu"))


def _check(case):
    """The plain version against ``pallas_interpret`` and the
    ``reference`` backend in the problem's dtype; returns the plan."""
    build, dims, bc, par_time, bsize, V, iters, dtype = case
    mine, want = _problems(build, dims, bc, dtype)
    p = _hopper(mine, par_time, bsize, V)
    g, aux = _data(mine)
    got = p.run(_t(g, dtype), iters, aux=_t(aux, dtype))
    assert got.dtype == mine.torch_dtype
    exp = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=V)).run(_j(g, dtype), iters, aux=_j(aux, dtype))
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(mine, iters))
    ref = plan(mine, RunConfig(backend="reference", device="cpu")).run(
        _t(g, dtype), iters, aux=_t(aux, dtype))
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(mine, iters))
    return p


def _case_id(case):
    build, dims, bc, _, bsize, V, _, dtype = case
    name = build(*PKGS["port"])
    name = name if isinstance(name, str) else build.__name__.strip("_")
    bc = bc if isinstance(bc, str) else "-".join(bc)
    return (f"{name}-{'x'.join(map(str, dims))}-b{'x'.join(map(str, bsize))}"
            f"-{bc}-V{V}-{dtype}")


#: (build, dims, boundary, par_time, bsize, par_vec, iters, dtype): block
#: planes over 1024 cells on the main-path, chain and DAG bodies
WIDE = [
    (_single("diffusion2d"), (6, 4200), "clamp", 8, (2048,), 1, 9, F32),
    (_single("hotspot2d"), (5, 4100), "reflect", 8, (2048,), 2, 9, BF16),
    (_single("diffusion3d"), (5, 50, 44), "clamp", 2, (42, 42), 1, 3, F32),
    (_single("hotspot3d"), (5, 50, 44), ("clamp", "constant:80.0", "clamp"),
     2, (42, 42), 2, 3, BF16),
    (lambda S, P, st: [S(st.make_star(2, 1)), S("diffusion2d")], (6, 2500),
     "clamp", 2, (1100,), 1, 5, F32),
    (_wave, (6, 2500), "periodic", 2, (1100,), 1, 5, F32),
]


@pytest.mark.parametrize("case", WIDE, ids=_case_id)
def test_wide_plane_matches_pallas_interpret_and_reference(case):
    """A block plane over 1024 cells plans (the wide form: a thread takes
    several cells) and agrees with both references."""
    p = _check(case)
    assert np.prod(p.geometry.bsize) > blocking.MAX_THREADS
    vt, rows, threads = builder.cta_shape(p.geometry)
    assert (vt, rows, threads) == (1, p.geometry.par_vec, 1024)


#: large tables: 250 taps (f32 and bf16), 17 stages, 196 coefficients
LARGE = [
    (_box_chain, (7, 12, 12), "clamp", 1, (10, 10), 1, 3, F32),
    (_box_chain, (7, 12, 12), "reflect", 1, (10, 10), 2, 2, BF16),
    (_damp_chain, (6, 40), "clamp", 1, (16,), 1, 3, F32),
    (_box2d_chain, (9, 60), "clamp", 1, (30,), 1, 2, F32),
]


@pytest.mark.parametrize("case", LARGE, ids=_case_id)
def test_large_table_matches_pallas_interpret_and_reference(case):
    """A program past the kernel parameter's tables plans (the
    large-table route) and agrees with both references."""
    p = _check(case)
    tab = builder.tables_of(p.geometry, p.problem.exec_dag)
    assert tab.big and builder.kernel_limits(p.geometry,
                                             p.problem.exec_dag) is None


@pytest.mark.parametrize("steps", [1, 0])
def test_large_table_superstep_matches_interpret_kernel(steps):
    """One super-step of the 250-tap chain against ``repro``'s
    ``superstep_chain(..., interpret=True)`` on the same padded input, on
    the grid's cells (``steps = 0`` forwards)."""
    dims = (7, 12, 12)
    mine, want = _problems(_box_chain, dims, "clamp", F32)
    geom = _hopper(mine, 1, (10, 10)).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=1, bsize=(10, 10))).geometry
    g, _ = _data(mine, seed=2)
    gp = ops._pad_blocked(_t(g, F32), geom, mine.structural_bc)
    jgp = jops._pad_blocked(_j(g, F32), jgeom, want.structural_bc)
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    h = geom.size_halo
    cells = (slice(0, dims[0]),) + tuple(slice(h, h + d) for d in dims[1:])
    got = builder.superstep_dag(mine.exec_dag, geom, gp, c, steps)
    exp = jbuilder.superstep_chain(want.exec_stages, jgeom, jgp, jc,
                                   jnp.asarray(steps, jnp.int32),
                                   interpret=True)
    np.testing.assert_allclose(_np(got[cells]), _np(exp[cells]),
                               **_tol(mine, max(steps, 1)))


@pytest.mark.parametrize("dims,bsize,V,n_entries,big,want", [
    ((6, 4200), (2048,), 1, 0, False, (1, 1, 1024)),
    ((6, 4200), (2048,), 4, 0, False, (1, 4, 1024)),
    ((6, 4200), (1025,), 2, 0, False, (1, 2, 1024)),
    ((5, 50, 44), (42, 42), 1, 0, False, (1, 1, 1024)),
    ((5, 500, 500), (64, 64), 4, 0, False, (1, 4, 1024)),
    ((6, 60), (16,), 1, 80, True, (1, 1, 32)),
    ((6, 60), (40,), 4, 80, True, (1, 4, 64)),
    ((4096,), (), 1, 2000, True, (1, 1, 32)),
    ((5, 50, 44), (32, 32), 2, 70, True, (1, 2, 1024)),
    ((5, 50, 44), (42, 42), 1, 70, True, (1, 1, 1024)),
])
def test_cta_shape_of_the_wide_form_and_large_tables(dims, bsize, V,
                                                     n_entries, big, want):
    """A plane over 1024 cells, and the large-table route at any plane,
    run one row of a slab at once, every row per thread, on ``min(plane,
    1024)`` threads rounded up to 32 (entries beyond them are strided)."""
    geom = blocking.BlockGeometry(len(dims), dims, 1, 2, bsize, V)
    tab = builder.Tables("chain", n_entries, 1, 0, 0, 1, 1, n_entries, 0,
                         0, 0) if n_entries else None
    assert (tab is not None and tab.big) == big
    assert builder.cta_shape(geom, tab) == want


def test_wide_planes_are_bound_by_shared_memory():
    """2D ``bsize = 2048`` at T=8 (196,608 bytes of rings) and a 3D plane
    of 64 x 64 at T=4 plan; ``bsize = 4096`` at T=8 (393,216) is refused
    by name."""
    d2 = StencilProblem("diffusion2d", (16384, 16384))
    g2 = _hopper(d2, 8, (2048,)).geometry
    assert blocking.smem_bytes(g2, d2.exec_stages) == 196608
    with pytest.raises(ValueError, match="393216 bytes of shared memory"):
        _hopper(d2, 8, (4096,))
    d3 = StencilProblem("hotspot3d", (448, 448, 448))
    g3 = _hopper(d3, 4, (64, 64)).geometry
    assert blocking.smem_bytes(g3, d3.exec_stages) == 196608
    with pytest.raises(ValueError, match="shared memory"):
        _hopper(d3, 4, (64, 64), V=2)


def test_large_table_holds_what_the_parameter_table_holds():
    """For a program under the caps, the table sized to the program holds
    the entries, stages, taps, coefficients and field streams of the
    kernel parameter's ``Program`` (its rows with 32-bit fields, each
    entry's inputs out of line), back to back; its bytes and the records'
    shared memory follow the kernel's layout."""
    S, P, st = PKGS["port"]
    problem = StencilProblem(_wave(S, P, st), (16, 40), boundary="reflect")
    geom = _hopper(problem, 3, (16,)).geometry
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    small, lag, n = builder._dag_table(dag, geom, c)
    big, big_lag, big_n = builder._dag_table(dag, geom, c, big=True)
    tab = builder.tables_of(geom, dag)
    assert (lag, n) == (big_lag, big_n) and not tab.big
    assert (len(big.e), len(big.s), len(big.taps), len(big.c), len(big.f),
            len(big.ins)) == (tab.entries, tab.stages, tab.taps, tab.coeffs,
                              tab.fields, tab.all_inputs)
    assert ctypes.sizeof(big) == (32 * tab.entries + 16 * tab.stages
                                  + 16 * tab.taps + 4 * tab.coeffs
                                  + 16 * tab.fields + 8 * tab.all_inputs)
    for i in range(tab.entries):
        e, b = small.e[i], big.e[i]
        assert [getattr(e, f) for f in ("lag", "stage", "iteration",
                                        "field", "out_base", "out_slots",
                                        "n_in")] == [
            getattr(b, f) for f in ("lag", "stage", "iteration", "field",
                                    "out_base", "out_slots", "n_in")]
        assert [(e.in_base[z], e.in_slots[z]) for z in range(e.n_in)] == [
            (big.ins[b.in_lo + z].base, big.ins[b.in_lo + z].slots)
            for z in range(b.n_in)]
    assert sum(big.e[i].n_in for i in range(tab.entries)) == tab.all_inputs
    for i in range(tab.stages):
        assert bytes(big.s[i]) == bytes(small.s[i])
    for name, fields in (("taps", ("ds", "dy", "dx", "ci")),
                         ("f", ("base", "slots", "out"))):
        for i in range(len(getattr(big, name))):
            assert [getattr(getattr(big, name)[i], f) for f in fields] == [
                getattr(getattr(small, name)[i], f) for f in fields]
    assert list(big.c) == list(small.c)[:tab.coeffs]
    assert _build.big_table_bytes("dag", 70, 5, 9, 100) == 9168
    assert _build.big_table_bytes("chain", 3, 250, 250) == 5392
    assert tab._replace(entries=70).smem == _build.big_table_bytes(
        "dag", 70, tab.taps, tab.coeffs, tab.all_inputs)
    assert tab.smem == _build.TABLE_SMEM["dag"]


def test_tables_past_16_bits_take_the_large_table_route():
    """Lags, ring slots and tap offsets past the parameter table's 16-bit
    and 8-bit fields take the large-table route, whose 32-bit fields hold
    them: the 1D ``make_star(1, 127)`` at T=150 has 38,250 ring slots; its
    table carries the ring bases past 32767 as laid out, and the plan
    agrees with the reference backend."""
    S, P, st = PKGS["port"]
    problem = StencilProblem([S(st.make_star(1, 127))], (700,))
    p = _hopper(problem, 150, ())
    geom, dag = p.geometry, problem.exec_dag
    tab = builder.tables_of(geom, dag)
    assert (tab.entries, tab.slots, tab.reach) == (150, 38250, 127)
    assert tab.big and builder.kernel_limits(geom, dag) is None
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    table, _ = builder._program_table(problem.exec_stages, geom, c, big=True)
    # the field stream's ring, then one of 255 slots per entry but the
    # last, which drains to the output
    bases = [table.e[i].out_base for i in range(tab.entries - 1)]
    assert bases == [255 * (i + 1) for i in range(149)]
    assert table.e[149].out_slots == 0
    assert [table.ins[i].base for i in range(tab.entries)] == [0] + bases
    for short in (dict(slots=32768), dict(lag=32768), dict(reach=128)):
        small = builder.Tables("dag", 8, 1, 3, 3, 1, 2, 10, 100, 10, 1)
        assert not small.big and small._replace(**short).big
    g, _ = _data(problem, seed=3)
    want = plan(problem, RunConfig(backend="reference", device="cpu")).run(
        _t(g, F32), 151)
    np.testing.assert_allclose(_np(p.run(_t(g, F32), 151)), _np(want),
                               **_tol(problem, 151))


def test_what_no_table_route_runs_is_refused():
    """Records that overflow shared memory are refused by name; a tap
    table of more than 256 taps (343, a coefficient index past a byte)
    and five field streams take the large-table route and agree with the
    reference backend."""
    S, P, st = PKGS["port"]
    chain = StencilProblem([S(st.make_star(1, 1))] * 2, (4000,))
    geom = blocking.BlockGeometry(1, (4000,), 2, 1000, ())
    tab = builder.tables_of(geom, chain.exec_stages)
    assert tab.entries == 2000 and tab.smem > blocking.SMEM_LIMIT
    assert "shared memory" in builder.kernel_limits(geom,
                                                    chain.exec_stages)
    five = tuple(f"f{i}" for i in range(5))
    for problem, T, bsize in (
            (StencilProblem([S(st.make_box(3, 3))], (8, 30, 30)), 1,
             (20, 20)),
            (StencilProblem(P(
                (S(st.make_star(2, 1), name="a", inputs=("f0",)),),
                fields=five,
                updates={"f0": "a", **{five[i]: five[i - 1]
                                       for i in range(1, 5)}}), (16, 32)),
             2, (16,))):
        p = _hopper(problem, T, bsize)
        assert builder.tables_of(p.geometry, problem.exec_dag).big
        g, _ = _data(problem, seed=4)
        want = plan(problem, RunConfig(backend="reference",
                                       device="cpu")).run(_t(g, F32), 3)
        np.testing.assert_allclose(_np(p.run(_t(g, F32), 3)), _np(want),
                                   **_tol(problem, 3))
