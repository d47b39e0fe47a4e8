"""V-row slabs (``par_vec > 1``) and 1D grids on the ``hopper`` backend
against the reference package on the same numpy inputs: the plain version
of the streaming kernel at V in {1, 2, 4, 8, 16} against ``repro``'s
``pallas_interpret`` backend at the same V (the Table-2 stencils in 2D and
3D, stream extents that V does and does not divide, clamp and periodic,
iteration counts that are not multiples of ``par_time``), one chain and one
DAG at V in {2, 4}, the 1D stars, one super-step against ``repro``'s
``superstep_chain``/``superstep_dag(..., interpret=True)`` at V = 4,
slab-pad rows that are never read, runs at V > 1 equal to V = 1 bit for
bit, the traffic report, the kernel's tables and CTA shape, and the
shared-memory refusals.  Tolerances are ``repro.core.precision.tolerance``.
"""
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
from repro_torch import programs
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, stencils
from repro_torch.kernels import builder, ops

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (japi.StencilStage, japi.StencilProgram, jstencils),
        "port": (StencilStage, StencilProgram, stencils)}


def _single(name):
    return lambda S, P, st: name


def _chain(S, P, st):
    return [S(st.make_star(2, 2)), S("diffusion2d")]


def _wave(S, P, st):
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return P((S(st.make_star(2, 1), coeffs=lap, name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _problems(build, dims, bc):
    """(port problem, reference problem) of the same program."""
    return (StencilProblem(build(*PKGS["port"]), dims, boundary=bc),
            japi.StencilProblem(build(*PKGS["repro"]), dims, boundary=bc))


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


def _hopper(problem, par_time, bsize, V):
    return plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V, device="cpu"))


#: (build, dims, boundary, par_time, bsize, par_vec, iters): the Table-2
#: stencils at every V, stream extents 37 and 13 that no V > 1 divides, 32
#: that all do, clamp and periodic
STENCIL_CASES = (
    [(_single("diffusion2d"), (37, 40), "clamp", 2, 16, V, 5)
     for V in (1, 2, 4, 8, 16)]
    + [(_single("diffusion2d"), (32, 40), "clamp", 2, 16, V, 5)
       for V in (4, 16)]
    + [(_single("diffusion2d"), (37, 40), "periodic", 2, 16, V, 5)
       for V in (4, 16)]
    + [(_single("hotspot2d"), (13, 33), "clamp", 2, 16, V, 5)
       for V in (1, 2, 4, 8, 16)]
    + [(_single("hotspot2d"), (13, 33), "periodic", 2, 16, 8, 5)]
    + [(_single("diffusion3d"), (13, 20, 20), "clamp", 2, (10, 10), V, 5)
       for V in (1, 2, 4, 8, 16)]
    + [(_single("diffusion3d"), (13, 20, 20), "periodic", 2, (10, 10), 2,
        5)]
    + [(_single("hotspot3d"), (13, 20, 20), "clamp", 2, (10, 10), V, 5)
       for V in (1, 2, 4, 8, 16)]
    + [(_single("hotspot3d"), (13, 20, 20), ("clamp", "periodic", "clamp"),
        2, (10, 10), 4, 5)])
#: one chain and one DAG at V in {2, 4}; the 1D stars at V in {1, 4, 16}
PROGRAM_CASES = (
    [(_chain, (24, 32), "clamp", 2, 16, V, 5) for V in (2, 4)]
    + [(_wave, (22, 19), "periodic", 2, 8, V, 5) for V in (2, 4)]
    + [(_single("star1d_r1"), (101,), "periodic", 3, (), V, 7)
       for V in (1, 4, 16)]
    + [(_single("star1d_r2"), (101,), "clamp", 3, (), V, 7)
       for V in (1, 4, 16)])


def _case_id(case):
    build, dims, bc, _, _, V, _ = case
    name = build(*PKGS["port"])
    name = name if isinstance(name, str) else build.__name__.strip("_")
    bc = bc if isinstance(bc, str) else "-".join(bc)
    return f"{name}-{'x'.join(map(str, dims))}-{bc}-V{V}"


@pytest.mark.parametrize("case", STENCIL_CASES + PROGRAM_CASES,
                         ids=_case_id)
def test_hopper_par_vec_matches_pallas_interpret(case):
    """The plain version at V against ``pallas_interpret`` at V, within
    tolerance, and against the port's own V = 1 run, bit for bit: V moves
    rows, it does not change what they hold."""
    build, dims, bc, par_time, bsize, V, iters = case
    mine, want = _problems(build, dims, bc)
    g, aux = _data(mine)
    got = _hopper(mine, par_time, bsize, V).run(g, iters, aux=aux)
    assert tuple(got.shape) == mine.state_shape
    pallas = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=V)).run(jnp.asarray(g), iters, aux=_j(aux))
    conf.assert_close(got, pallas, _tol(mine, iters))
    if V > 1:
        v1 = _hopper(mine, par_time, bsize, 1).run(g, iters, aux=aux)
        assert torch.equal(got, v1)


def _padded(mine, want, geom, jgeom, seed=2):
    """The same padded state (and aux) in both packages."""
    bc0 = mine.structural_bc
    g, aux = _data(mine, seed)
    gp = ops._pad_blocked(torch.from_numpy(g), geom, bc0)
    jgp = jops._pad_blocked(jnp.asarray(g), jgeom, want.structural_bc)
    assert tuple(gp.shape) == tuple(jgp.shape)
    aux_p = jaux_p = None
    if aux is not None:
        aux_p = ops._pad_blocked(torch.from_numpy(aux), geom, bc0)
        jaux_p = jops._pad_blocked(jnp.asarray(aux), jgeom,
                                   want.structural_bc)
    return gp, jgp, aux_p, jaux_p


def _region(geom, bc0):
    """Rows below the real stream extent of every block's compute
    columns."""
    h = geom.size_halo
    return ((Ellipsis, slice(0, builder._stream_dom(geom, bc0)))
            + tuple(slice(h, h + n * cs)
                    for n, cs in zip(geom.bnum, geom.csize)))


#: id -> (build, dims, boundary, par_time, bsize): super-steps at V = 4
SUPERSTEPS = {
    "diffusion2d": (_single("diffusion2d"), (37, 40), "clamp", 2, 16),
    "hotspot3d": (_single("hotspot3d"), (13, 20, 20), "clamp", 2, (10, 10)),
    "wave2d_periodic": (_wave, (22, 19), "periodic", 2, 8),
}


@pytest.mark.parametrize("name", sorted(SUPERSTEPS))
def test_plain_superstep_matches_pallas_interpret_at_v4(name):
    """``superstep_chain``/``superstep_dag``'s plain version against
    ``repro``'s ``superstep_chain``/``superstep_dag(..., interpret=True)``
    at V = 4 on the same padded input, on the rows below the real stream
    extent of the compute region, with ``steps = par_time`` and
    ``par_time - 1``."""
    build, dims, bc, par_time, bsize = SUPERSTEPS[name]
    mine, want = _problems(build, dims, bc)
    geom = _hopper(mine, par_time, bsize, 4).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=4)).geometry
    gp, jgp, aux_p, jaux_p = _padded(mine, want, geom, jgeom)
    region = _region(geom, mine.structural_bc)
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    for steps in (par_time, par_time - 1):
        js = jnp.asarray(steps, jnp.int32)
        if mine.is_dag:
            got = builder.superstep_dag(mine.exec_dag, geom, gp, c, steps,
                                        aux_p)
            exp = jbuilder.superstep_dag(want.exec_dag, jgeom, jgp, jc, js,
                                         jaux_p, interpret=True)
        else:
            got = builder.superstep_chain(mine.exec_stages, geom, gp, c,
                                          steps, aux_p)
            exp = jbuilder.superstep_chain(want.exec_stages, jgeom, jgp, jc,
                                           js, jaux_p, interpret=True)
        conf.assert_close(got[region], np.asarray(exp)[region],
                          _tol(mine, steps))


#: (build, dims, boundary, par_time, bsize, par_vec): slab pads of 3, 3,
#: 3 and 11 rows (the periodic extension included)
PADDED = [(_single("diffusion2d"), (37, 40), "clamp", 2, 16, 4),
          (_single("hotspot3d"), (13, 20, 20), "clamp", 2, (10, 10), 4),
          (_wave, (22, 19), "periodic", 2, 8, 4),
          (_single("star1d_r2"), (101,), "clamp", 3, (), 16)]


@pytest.mark.parametrize("case", PADDED,
                         ids=lambda c: _case_id(c + (0,)))
def test_slab_pad_rows_are_never_read(case):
    """Input rows at or past the real stream extent set to NaN (aux too)
    leave the super-step's result finite and unchanged; its own pad rows
    are left as they were."""
    build, dims, bc, par_time, bsize, V = case
    mine, _ = _problems(build, dims, bc)
    geom = _hopper(mine, par_time, bsize, V).geometry
    bc0 = mine.structural_bc
    dom = builder._stream_dom(geom, bc0)
    g, aux = _data(mine, seed=3)
    gp = ops._pad_blocked(torch.from_numpy(g), geom, bc0)
    aux_p = (None if aux is None
             else ops._pad_blocked(torch.from_numpy(aux), geom, bc0))
    ns = gp.shape[-geom.ndim]
    assert ns > dom and ns % V == 0 and ns - dom < V
    pad_rows = (Ellipsis, slice(dom, None)) + (slice(None),) * (
        geom.ndim - 1)
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    region = _region(geom, bc0)
    clean = builder.superstep_dag(mine.exec_dag, geom, gp, c, par_time,
                                  aux_p)
    gp[pad_rows] = float("nan")
    if aux_p is not None:
        aux_p[pad_rows] = float("nan")
    out = torch.full_like(gp, 7.0)
    builder.superstep_dag(mine.exec_dag, geom, gp, c, par_time, aux_p,
                          out=out)
    assert bool(out[region].isfinite().all())
    assert torch.equal(out[region], clean[region])
    assert bool((out[pad_rows] == 7.0).all())


@pytest.mark.parametrize("case", [
    (_single("diffusion2d"), (37, 40), "clamp", 2, 16, 4),
    (_single("diffusion2d"), (37, 40), "periodic", 2, 16, 16),
    (_single("hotspot3d"), (13, 20, 20), "clamp", 2, (10, 10), 8),
    (_wave, (22, 19), "periodic", 2, 8, 4),
    (_single("star1d_r2"), (101,), "periodic", 3, (), 16),
], ids=lambda c: _case_id(c + (0,)))
def test_traffic_report_bills_the_slab_pad(case):
    """The device-memory bytes bill the padded stream, as ``repro``'s do;
    the rings hold ``par_vec`` rows per slot."""
    build, dims, bc, par_time, bsize, V = case
    mine, want = _problems(build, dims, bc)
    p = _hopper(mine, par_time, bsize, V)
    jp = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=V))
    tr, jtr = p.traffic_report(9), jp.traffic_report(9)
    for k in ("model_bytes_per_superstep", "kernel_dma_bytes_per_superstep",
              "kernel_dma_bytes_total", "n_super", "par_vec"):
        assert tr[k] == jtr[k], k
    geom = p.geometry
    assert ops.dma_traffic_bytes(mine.stencil, geom, 4, mine.structural_bc) \
        == jops.dma_traffic_bytes(want.stencil, jp.geometry, 4,
                                  want.structural_bc)
    lay = programs.dag_layout(programs.unroll_dag(mine.exec_dag, par_time),
                              V)
    assert tr["smem_bytes"] == sum(lay.wins) * V * int(
        np.prod(geom.bsize)) * 4


def test_kernel_tables_follow_the_slab_layout():
    """At V = 4 the entry tables carry ``dag_layout(plan, 4)``: lags and
    ring depths in slabs, as ``repro``'s layout has them."""
    V = 4
    mine, want = _problems(_chain, (24, 32), "clamp")
    geom = _hopper(mine, 2, 16, V).geometry
    up = programs.unroll_dag(mine.exec_dag, 2)
    lay = programs.dag_layout(up, V)
    jlay = jprograms.dag_layout(jprograms.unroll_dag(want.exec_dag, 2), V)
    assert (lay.radii, lay.lags, lay.wins, lay.out_lag) == (
        jlay.radii, jlay.lags, jlay.wins, jlay.out_lag)
    assert lay.radii == (1, 1, 1, 1)     # ceil(2/4) and ceil(1/4)
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    table, out_lag = builder._program_table(mine.exec_stages, geom, c)
    assert out_lag == lay.out_lag == 4
    for i in range(len(up.entries)):
        e = table.e[i]
        assert (e.lag, e.in_slots[0], e.out_slots) == (
            lay.lags[1 + i], lay.wins[i], lay.wins[1 + i])
    wave, _ = _problems(_wave, (22, 19), "periodic")
    wgeom = _hopper(wave, 2, 8, V).geometry
    wup = programs.unroll_dag(wave.exec_dag, 2)
    wlay = programs.dag_layout(wup, V)
    wc = ops.pack_dag_coeffs(wave.exec_dag, wave.resolve_coeffs())
    table, out_lag, n = builder._dag_table(wave.exec_dag, wgeom, wc)
    assert (n, out_lag) == (len(wup.entries), wlay.out_lag)
    for i, e in enumerate(wup.entries):
        assert table.e[i].lag == wlay.lags[2 + i]
        assert [table.e[i].in_slots[z] for z in range(len(e.inputs))] == [
            wlay.wins[p] for p in e.inputs]


@pytest.mark.parametrize("dims,bsize,V,n_entries,want", [
    ((64, 600), (256,), 1, 0, (1, 1, 256)),
    ((64, 600), (256,), 2, 0, (1, 2, 256)),
    ((64, 600), (256,), 4, 0, (1, 4, 256)),
    ((64, 600), (256,), 8, 0, (1, 8, 256)),
    ((64, 600), (256,), 16, 0, (1, 16, 256)),
    ((16, 64, 64), (32, 32), 4, 0, (1, 4, 1024)),
    ((16, 64, 64), (20, 20), 3, 0, (1, 3, 416)),
    ((4096,), (), 16, 0, (1, 16, 32)),
    ((4096,), (), 1, 8, (1, 1, 32)),
    ((20, 60), (12,), 1, 40, (1, 1, 64)),
    ((64, 600), (256,), 2, 4, (2, 1, 512)),
    ((64, 600), (256,), 16, 4, (4, 4, 1024)),
    ((4096,), (), 16, 8, (16, 1, 32)),
])
def test_cta_shape_follows_the_launcher_rule(dims, bsize, V, n_entries,
                                             want):
    """For a table-driven body ``vt`` the largest divisor of V with
    ``plane * vt <= 1024``, rows per thread ``V / vt``, threads rounded up
    to a multiple of 32 and to its entries; the main-path body (no table)
    takes every row of a slab per thread."""
    geom = blocking.BlockGeometry(len(dims), dims, 1, 2, bsize, V)
    tab = builder.Tables("chain", n_entries, 1, 0, 0, 1, 1, n_entries, 0,
                         0, 0) if n_entries else None
    assert builder.cta_shape(geom, tab) == want


def test_hopper_refuses_oversized_par_vec_by_shared_memory():
    """The rings grow with V: what does not fit one CTA is refused by
    ``kernel_limits``, naming shared memory; what fits plans."""
    d2 = StencilProblem("diffusion2d", (16384, 16384))
    assert _hopper(d2, 8, 256, 8).geometry.par_vec == 8    # 196,608 bytes
    with pytest.raises(ValueError, match="393216 bytes of shared memory"):
        _hopper(d2, 8, 256, 16)
    d3 = StencilProblem("diffusion3d", (448, 448, 448))
    assert _hopper(d3, 4, (32, 32), 4).geometry.par_vec == 4
    with pytest.raises(ValueError, match="393216 bytes of shared memory"):
        _hopper(d3, 4, (32, 32), 8)
    wave, _ = _problems(_wave, (64, 64), "periodic")
    with pytest.raises(ValueError, match="shared memory"):
        _hopper(wave, 4, 48, 64)
