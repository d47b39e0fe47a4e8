"""The reflect and constant boundaries on the ``hopper`` backend against the
reference package on the same numpy inputs: the plain version of the
streaming kernel with each kind on each axis (2D, 3D, 1D), a chain whose
stages differ in boundary, DAGs whose stages share one and DAGs whose
stages differ (the diamond, the wave equation in 2D and 3D, a Hotspot DAG,
a field stream read under another boundary than stage 0's), in float32
and bfloat16, against ``repro``'s ``pallas_interpret`` backend and the
``reference`` backend; one super-step of a mixed chain, a single-boundary
DAG and mixed-boundary DAGs against ``repro``'s interpret-mode kernel;
the mirrored stream rows against the rows the rings hold at every V; the
boundary columns of the kernel's stage table.  Tolerances are
``repro.core.precision.tolerance(dtype, iters, stages)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro.kernels import builder as jbuilder
from repro.kernels import ops as jops
from repro_torch import programs
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, boundary, stencils
from repro_torch.kernels import builder, ops

torch.set_num_threads(1)

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (japi.StencilStage, japi.StencilProgram, jstencils),
        "port": (StencilStage, StencilProgram, stencils)}
F32, BF16 = "float32", "bfloat16"


def _single(name):
    return lambda S, P, st: name


def _mixed_chain(S, P, st):
    """An upwind star under reflect, then diffusion under a constant
    stream axis and a reflect x axis: the stages differ in boundary."""
    return [S(st.make_star(2, 1), coeffs={"c0": 0.7, "c_0_-1": 0.1,
                                          "c_0_1": 0.0, "c_1_-1": 0.2,
                                          "c_1_1": 0.0}, boundary="reflect"),
            S("diffusion2d", boundary=("constant:0.0", "reflect"))]


def _wave(S, P, st):
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return P((S(st.make_star(2, 1), coeffs=lap, name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond(S, P, st):
    s = st.make_star(2, 1)
    return P((S(s, name="a", inputs=("u",)),
              S(s, name="b", inputs=("u",),
                coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


def _mixed_diamond(S, P, st):
    """The diamond with ``a`` clamp, ``b`` reflect (it reads the field
    stream, which arrives padded under ``a``'s clamp) and the combine
    constant 0.5."""
    a, b, m = _diamond(S, P, st).stages
    return P((S(a.stencil, name="a", inputs=("u",), boundary="clamp"),
              S(b.stencil, name="b", inputs=("u",), coeffs=b.coeffs,
                boundary="reflect"),
              S(m.stencil, name="m", inputs=("a", "b"), coeffs=m.coeffs,
                boundary="constant:0.5")))


def _mixed_wave(S, P, st):
    """The 2D wave equation with a reflect Laplacian and a clamp combine."""
    lapu, unext = _wave(S, P, st).stages
    return P((S(lapu.stencil, coeffs=lapu.coeffs, name="lapu",
                inputs=("u",), boundary="reflect"),
              S(unext.stencil, coeffs=unext.coeffs, name="unext",
                inputs=unext.inputs, boundary="clamp")),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _mixed_wave3d(S, P, st):
    """The 3D wave equation: the Laplacian reflect along the stream axis,
    constant 0.25 along y and clamp along x, the combine reflect."""
    lap = {"c0": -6.0}
    lap.update({f"c_{a}_{d}": 1.0 for a in range(3) for d in (-1, 1)})
    return P((S(st.make_star(3, 1), coeffs=lap, name="lapu", inputs=("u",),
                boundary=("reflect", "constant:0.25", "clamp")),
              S(st.make_combine(3, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1},
                boundary="reflect")),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _mixed_hotspot_dag(S, P, st):
    """A Hotspot stage (constant stream axis, reflect x) blended with the
    raw field and a trailing second field by a clamp combine."""
    return P((S("hotspot2d", name="h", inputs=("u",),
                boundary=("constant:80.0", "reflect")),
              S(st.make_combine(2, 3), name="m", inputs=("h", "u", "v"),
                coeffs={"w0": 0.5, "w1": 0.3, "w2": 0.2},
                boundary="clamp")),
             fields=("u", "v"), updates={"u": "m", "v": "u"})


def _field_stream_mixed(S, P, st):
    """The field stream, padded under stage 0's reflect, read by a
    diffusion under constant 1.0 and by a clamp combine."""
    return P((S(st.make_star(2, 2), name="s0", inputs=("u",),
                boundary="reflect"),
              S("diffusion2d", name="s1", inputs=("u",),
                boundary="constant:1.0"),
              S(st.make_combine(2, 3), name="m", inputs=("s0", "s1", "u"),
                coeffs={"w0": 0.3, "w1": 0.5, "w2": 0.2},
                boundary="clamp")))


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


#: (build, dims, boundary, par_time, bsize, par_vec, iters, dtype): each
#: kind on each axis, a mixed chain, DAGs under one boundary
CASES = [
    (_single("diffusion2d"), (29, 40), ("reflect", "clamp"), 2, 16, 1, 5,
     F32),
    (_single("diffusion2d"), (29, 40), ("clamp", "reflect"), 2, 16, 2, 5,
     BF16),
    (_single("diffusion2d"), (29, 40), ("constant:1.5", "clamp"), 2, 16, 4,
     5, BF16),
    (_single("diffusion2d"), (29, 40), ("clamp", "constant:1.5"), 2, 16, 1,
     5, F32),
    (_single("hotspot2d"), (13, 33), ("reflect", "constant:80.0"), 3, 16, 1,
     7, F32),
    (_single("hotspot3d"), (9, 12, 12), ("clamp", "reflect", "clamp"), 2,
     (10, 10), 2, 5, F32),
    (_single("hotspot3d"), (9, 12, 12), ("clamp", "clamp", "constant:80.0"),
     2, (10, 10), 1, 5, BF16),
    (_single("diffusion3d"), (9, 12, 12),
     ("reflect", "constant:0.5", "reflect"), 2, (10, 10), 4, 5, F32),
    (_single("diffusion3d"), (9, 12, 12),
     ("constant:0.5", "reflect", "constant:0.5"), 2, (10, 10), 2, 5, BF16),
    (_single("star1d_r2"), (101,), "reflect", 3, (), 4, 7, F32),
    (_single("star1d_r1"), (101,), "constant:2.0", 3, (), 1, 7, BF16),
    (_mixed_chain, (24, 32), "clamp", 2, 16, 1, 5, F32),
    (_mixed_chain, (24, 32), "clamp", 2, 16, 2, 5, BF16),
    (_wave, (22, 19), "reflect", 2, 8, 1, 5, F32),
    (_diamond, (21, 40), "constant:0.25", 2, 16, 2, 5, BF16),
]

#: DAGs whose stages differ in boundary (ROADMAP B1k), in the CASES form
#: (the stages carry their own boundaries)
MIXED_DAGS = [
    (_mixed_diamond, (21, 40), "clamp", 2, 16, 1, 5, F32),
    (_mixed_diamond, (21, 40), "clamp", 2, 16, 2, 5, BF16),
    (_mixed_wave, (22, 19), "clamp", 2, 8, 1, 5, F32),
    (_mixed_wave, (22, 19), "clamp", 3, 12, 4, 7, BF16),
    (_mixed_hotspot_dag, (17, 23), "clamp", 2, 8, 1, 5, F32),
    (_mixed_hotspot_dag, (17, 23), "clamp", 2, 8, 2, 5, BF16),
    (_mixed_wave3d, (11, 14, 13), "clamp", 2, (8, 8), 1, 5, F32),
    (_mixed_wave3d, (11, 14, 13), "clamp", 2, (8, 8), 2, 3, BF16),
    (_field_stream_mixed, (20, 30), "clamp", 2, 16, 1, 5, F32),
    (_field_stream_mixed, (20, 30), "clamp", 2, 16, 1, 5, BF16),
]


def _case_id(case):
    build, dims, bc, _, _, V, _, dtype = case
    name = build(*PKGS["port"])
    name = name if isinstance(name, str) else build.__name__.strip("_")
    bc = bc if isinstance(bc, str) else "-".join(bc)
    return f"{name}-{'x'.join(map(str, dims))}-{bc}-V{V}-{dtype}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bc_hopper_matches_pallas_interpret(case):
    """The plain version under reflect and constant boundaries agrees with
    ``pallas_interpret`` in the problem's dtype and returns that dtype."""
    build, dims, bc, par_time, bsize, V, iters, dtype = case
    mine, want = _problems(build, dims, bc, dtype)
    g, aux = _data(mine)
    got = _hopper(mine, par_time, bsize, V).run(_t(g, dtype), iters,
                                                aux=_t(aux, dtype))
    assert got.dtype == mine.torch_dtype
    exp = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=V)).run(_j(g, dtype), iters, aux=_j(aux, dtype))
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(mine, iters))


@pytest.mark.parametrize("case", MIXED_DAGS, ids=_case_id)
def test_mixed_boundary_dag_matches_pallas_interpret_and_reference(case):
    """A DAG whose stages differ in boundary: every consumer re-imposes
    what it reads under its own boundary, as ``repro``'s ``cat_of``.  The
    plain version agrees with ``pallas_interpret`` and the ``reference``
    backend in the problem's dtype."""
    build, dims, bc, par_time, bsize, V, iters, dtype = case
    mine, want = _problems(build, dims, bc, dtype)
    p = _hopper(mine, par_time, bsize, V)
    assert builder.mixes_boundaries(mine.exec_dag, mine.ndim)
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


@pytest.mark.parametrize("build,dims,bc,dtype", [
    (_mixed_chain, (24, 32), "clamp", BF16),
    (_diamond, (21, 40), ("reflect", "constant:0.5"), F32),
    (_mixed_diamond, (21, 40), "clamp", F32),
    (_field_stream_mixed, (20, 30), "clamp", BF16),
], ids=["mixed_chain_bf16", "diamond_f32", "mixed_diamond_f32",
        "field_stream_mixed_bf16"])
def test_bc_superstep_matches_interpret_kernel(build, dims, bc, dtype):
    """One super-step of the plain version against ``repro``'s
    ``superstep_chain``/``superstep_dag(..., interpret=True)`` on the same
    padded input, with and without forwarding, on the grid's cells."""
    mine, want = _problems(build, dims, bc, dtype)
    par_time, bsize = 2, 16
    geom = _hopper(mine, par_time, bsize).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time,
        bsize=bsize)).geometry
    g, _ = _data(mine, seed=2)
    gp = ops._pad_blocked(_t(g, dtype), geom, mine.structural_bc)
    jgp = jops._pad_blocked(_j(g, dtype), jgeom, want.structural_bc)
    assert tuple(gp.shape) == jgp.shape
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    h = geom.size_halo
    cells = ((Ellipsis, slice(0, dims[0]))
             + tuple(slice(h, h + d) for d in dims[1:]))
    for steps in (par_time, par_time - 1):
        js = jnp.asarray(steps, jnp.int32)
        got = builder.superstep_dag(mine.exec_dag, geom, gp, c, steps)
        if mine.is_dag:
            exp = jbuilder.superstep_dag(want.exec_dag, jgeom, jgp, jc, js,
                                         interpret=True)
        else:
            exp = jbuilder.superstep_chain(want.exec_stages, jgeom, jgp, jc,
                                           js, interpret=True)
        np.testing.assert_allclose(_np(got[cells]), _np(exp[cells]),
                                   **_tol(mine, steps))


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("V", [1, 2, 4, 8, 16])
def test_mirrored_stream_rows_stay_in_the_ring(radius, V):
    """A reflect stream tap of a real row lands on a row that the
    producer's ring holds when the entry computes that row: within the
    layout's slab radius ``R`` of the row's slab (``dag_layout``'s lags),
    and the ring is at least ``2R + 1`` slabs deep.  Checked for stream
    extents down to two rows, shorter than the radius."""
    st = stencils.make_star(1, radius)
    chain = programs.chain_dag(((st, None), (st, None)))
    plan_ = programs.unroll_dag(chain, 3)
    lay = programs.dag_layout(plan_, V)
    F = plan_.n_streams
    for i, e in enumerate(plan_.entries):
        (p,) = e.inputs
        R = lay.lags[F + i] - lay.lags[p]
        assert R == -(-radius // V) and lay.wins[p] >= 2 * R + 1
        for dom in (2, 3, 5, 37):
            for x in range(dom):
                j = x // V
                lo, hi = (j - R) * V, (j + R) * V + V - 1
                rows = torch.arange(x - radius, x + radius + 1)
                mirrored = boundary.map_index(rows, 0, dom - 1, "reflect")
                assert bool(((mirrored >= max(lo, 0))
                             & (mirrored <= min(hi, dom - 1))).all())
                assert bool(((mirrored - x).abs() <= radius).all())


def test_stage_table_carries_the_boundaries():
    """Per stage the kernel's table holds the stream, blocked-y and
    blocked-x kinds (an axis the grid lacks re-imposes nothing) and the
    fill."""
    mine, _ = _problems(_mixed_chain, (24, 32), "clamp", F32)
    geom = _hopper(mine, 2, 16).geometry
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    table, _ = builder._program_table(mine.exec_stages, geom, c)
    ids = builder.BC_IDS
    got = [(table.s[i].ks, table.s[i].ky, table.s[i].kx, table.s[i].fill)
           for i in range(2)]
    assert got == [(ids["reflect"], ids["periodic"], ids["reflect"], 0.0),
                   (ids["constant"], ids["periodic"], ids["reflect"], 0.0)]
    prob = StencilProblem("hotspot3d", (9, 12, 12),
                          boundary=("reflect", "constant:80.0", "clamp"))
    geom = _hopper(prob, 2, (10, 10)).geometry
    c = ops.pack_dag_coeffs(prob.exec_dag, prob.resolve_coeffs())
    table, _ = builder._program_table(prob.exec_stages, geom, c)
    s = table.s[0]
    assert (s.ks, s.ky, s.kx, s.fill) == (
        ids["reflect"], ids["constant"], ids["clamp"], 80.0)


def test_dags_whose_stages_differ_in_boundary_are_refused():
    """A DAG whose combine alone is reflect plans (ROADMAP B1k is
    ported): its super-step agrees with ``repro``'s interpret-mode kernel
    on the grid's cells, and its run with ``pallas_interpret``; a chain
    may mix boundaries too."""
    def mixed(S, P, st):
        a, b, m = _diamond(S, P, st).stages
        return P((a, b, S(m.stencil, name="m", inputs=("a", "b"),
                          coeffs=m.coeffs, boundary="reflect")))
    mine, want = _problems(mixed, (21, 40), "clamp", F32)
    geom = blocking.BlockGeometry(2, (21, 40), 1, 2, (16,))
    assert _hopper(mine, 2, 16).geometry == geom
    dag = mine.exec_dag
    assert builder.kernel_limits(geom, dag) is None
    g, _ = _data(mine, seed=3)
    jgeom = japi.plan(want, japi.RunConfig(backend="pallas_interpret",
                                           par_time=2, bsize=16)).geometry
    gp = ops._pad_blocked(_t(g, F32), geom, mine.structural_bc)
    jgp = jops._pad_blocked(_j(g, F32), jgeom, want.structural_bc)
    c = ops.pack_dag_coeffs(dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    cells = (slice(0, 21), slice(geom.size_halo, geom.size_halo + 40))
    got = builder.superstep_dag(dag, geom, gp, c, 2)
    exp = jbuilder.superstep_dag(want.exec_dag, jgeom, jgp, jc,
                                 jnp.asarray(2, jnp.int32), interpret=True)
    np.testing.assert_allclose(_np(got[cells]), _np(exp[cells]),
                               **_tol(mine, 2))
    run = _hopper(mine, 2, 16).run(_t(g, F32), 5)
    exp = japi.plan(want, japi.RunConfig(backend="pallas_interpret",
                                         par_time=2, bsize=16)).run(
                                             _j(g, F32), 5)
    np.testing.assert_allclose(_np(run), _np(exp), **_tol(mine, 5))
    chain, _ = _problems(_mixed_chain, (24, 32), "clamp", F32)
    assert _hopper(chain, 2, 16).geometry.par_time == 2
