"""The port's blocked engine (``core/engine.py``) and its ``engine`` backend
against the reference package's on the same numpy inputs: blocks cut and
stitched back exactly (and equal to ``repro``'s blocks), one super-step
with and without ``bounds``, ``plan(backend="engine")`` for the four
Table-2 stencils, every boundary kind, a chain, the 2-field wave equation
(a DAG), bf16, ``run_batch`` with shared and per-member aux, ``iters`` not
a multiple of ``par_time`` and ``iters = 0``, and the plan-time rules of a
backend that runs a row a tick.  Tolerances are
``repro_torch.core.precision.tolerance(dtype, iters, stages)``; the port's
engine against its own oracle is held bit for bit where it is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import engine as jengine
from repro.core import stencils as jstencils
from repro.core.blocking import BlockGeometry as JGeom
from repro.core.boundary import BoundaryCondition as JBC
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.convert import coeffs_from_reference
from repro_torch.core import engine, precision, stencils
from repro_torch.core.blocking import BlockGeometry
from repro_torch.core.boundary import BoundaryCondition

torch.set_num_threads(1)

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (japi.StencilStage, japi.StencilProgram, jstencils),
        "port": (StencilStage, StencilProgram, stencils)}


def _single(name):
    return lambda S, P, st: name


def _chain(S, P, st):
    """A radius-2 star under reflect, then diffusion: summed radius 3."""
    return [S(st.make_star(2, 2), boundary="reflect"), S("diffusion2d")]


def _wave(S, P, st):
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return P((S(st.make_star(2, 1), coeffs=lap, name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond(S, P, st):
    """Two radius-1 views of ``u`` into a 2-way combine: critical-path
    radius 1, summed radius 2."""
    s = st.make_star(2, 1)
    return P((S(s, name="a", inputs=("u",)),
              S(s, name="b", inputs=("u",), coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


def _problems(build, dims, bc, dtype="float32"):
    """(port problem, reference problem) of the same program."""
    return (StencilProblem(build(*PKGS["port"]), dims, boundary=bc,
                           dtype=dtype),
            japi.StencilProblem(build(*PKGS["repro"]), dims, boundary=bc,
                                dtype=dtype))


def _data(problem, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    g = rng.uniform(0.5, 2.0, lead + problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.uniform(0.0, 0.1, problem.shape).astype(np.float32)
    return g, aux


def _t(x, dtype="float32"):
    return None if x is None else torch.from_numpy(np.asarray(x)).to(
        precision.torch_dtype(dtype))


def _j(x, dtype="float32"):
    return None if x is None else jnp.asarray(x, getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _tol(problem, iters):
    return precision.tolerance(problem.dtype, iters, stages=problem.n_stages,
                               scale=100 if problem.needs_aux else None)


def _engine(problem, par_time, bsize, **kw):
    return plan(problem, RunConfig(backend="engine", par_time=par_time,
                                   bsize=bsize, device="cpu", **kw))


def _jengine(jproblem, par_time, bsize):
    return japi.plan(jproblem, japi.RunConfig(backend="engine",
                                              par_time=par_time, bsize=bsize))


# --- blocks ------------------------------------------------------------------

@pytest.mark.parametrize("dims,rad,par_time,bsize,bc,lead", [
    ((37, 53), 1, 4, (24,), "clamp", ()),
    ((37, 53), 2, 2, (20,), "periodic", (3,)),
    ((9, 21, 19), 1, 2, (12, 10), ("clamp", "reflect", "constant:0.5"), ()),
    ((9, 21, 19), 1, 3, (10, 12), "periodic", (2, 2)),
    ((41,), 2, 3, (), "reflect", ()),
])
def test_extract_and_stitch_round_trip_and_match_reference(
        dims, rad, par_time, bsize, bc, lead):
    """Cutting blocks and stitching their compute regions back gives the
    grid bit for bit, leading axes included; the blocks equal
    ``repro``'s."""
    geom = BlockGeometry(len(dims), dims, rad, par_time, bsize)
    g = np.random.default_rng(1).uniform(0.5, 2.0, lead + dims).astype(
        np.float32)
    tbc = BoundaryCondition.make(bc, len(dims))
    blocks = engine.extract_blocks(_t(g), geom, tbc)
    assert tuple(blocks.shape) == lead + geom.bnum + (dims[0],) + bsize
    assert torch.equal(engine.stitch_blocks(blocks, geom), _t(g))
    if not lead:
        jgeom = JGeom(len(dims), dims, rad, par_time, bsize)
        want = jengine.extract_blocks(_j(g), jgeom,
                                      JBC.make(bc, len(dims)))
        np.testing.assert_array_equal(blocks.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,dims,bc,bsize,bounds", [
    ("diffusion2d", (24, 40), "clamp", (16,), None),
    ("diffusion2d", (24, 40), "reflect", (16,), ((0, 19), (3, 39))),
    ("hotspot2d", (24, 40), ("constant:0.7", "reflect"), (16,),
     ((4, 23), (0, 35))),
    ("diffusion3d", (10, 20, 20), ("reflect", "clamp", "constant:0.5"),
     (12, 12), ((2, 9), (0, 19), (4, 15))),
])
def test_blocked_superstep_matches_reference(name, dims, bc, bsize, bounds):
    """One super-step of 3 and one of 2 (PE forwarding) iterations at
    ``par_time`` 3, with and without the multi-device runtime's
    ``bounds`` (a lower seam and an upper grid edge)."""
    st, jst = stencils.STENCILS[name], jstencils.STENCILS[name]
    jc = jstencils.default_coeffs(jst)
    tc = coeffs_from_reference(st, {k: np.asarray(v) for k, v in jc.items()})
    nd = len(dims)
    g = np.random.default_rng(2).uniform(0.5, 2.0, dims).astype(np.float32)
    aux = (np.random.default_rng(3).uniform(0, 0.1, dims).astype(np.float32)
           if st.has_aux else None)
    for steps in (3, 2):
        got = engine.blocked_superstep(
            st, BlockGeometry(nd, dims, 1, 3, bsize), _t(g), tc, steps,
            _t(aux), bounds, BoundaryCondition.make(bc, nd))
        want = jengine.blocked_superstep(
            jst, JGeom(nd, dims, 1, 3, bsize), _j(g), jc, steps, _j(aux),
            bounds, JBC.make(bc, nd))
        np.testing.assert_allclose(
            _np(got), _np(want), **precision.tolerance(
                "float32", steps, scale=100 if st.has_aux else None))


# --- the engine backend ------------------------------------------------------

#: (build, dims, boundary, par_time, bsize, iters, dtype)
CASES = [
    (_single("diffusion2d"), (37, 53), "clamp", 4, 24, 7, "float32"),
    (_single("hotspot2d"), (37, 53), "clamp", 3, 20, 8, "float32"),
    (_single("diffusion3d"), (9, 21, 19), "clamp", 2, (12, 12), 5,
     "float32"),
    (_single("hotspot3d"), (9, 21, 19), "clamp", 4, (16, 16), 5, "float32"),
    (_single("diffusion2d"), (29, 40), "periodic", 2, 16, 5, "float32"),
    (_single("diffusion2d"), (29, 40), "reflect", 3, 16, 4, "float32"),
    (_single("diffusion2d"), (29, 40), ("constant:1.5", "reflect"), 2, 16,
     5, "float32"),
    (_single("hotspot3d"), (9, 12, 12), ("periodic", "reflect",
                                         "constant:80.0"), 2, (10, 10), 5,
     "float32"),
    (_single("star1d_r2"), (101,), "reflect", 3, (), 7, "float32"),
    (_chain, (24, 40), "clamp", 2, 16, 5, "float32"),
    (_wave, (22, 19), "periodic", 2, 8, 5, "float32"),
    (_diamond, (21, 40), ("clamp", "reflect"), 2, 16, 5, "float32"),
    (_single("diffusion2d"), (29, 40), "clamp", 2, 16, 5, "bfloat16"),
    (_wave, (22, 19), "reflect", 2, 8, 3, "bfloat16"),
]


@pytest.mark.parametrize("build,dims,bc,par_time,bsize,iters,dtype", CASES)
def test_engine_backend_matches_reference_engine(build, dims, bc, par_time,
                                                 bsize, iters, dtype):
    prob, jprob = _problems(build, dims, bc, dtype)
    g, aux = _data(prob)
    got = _engine(prob, par_time, bsize).run(_t(g, dtype), iters,
                                             aux=_t(aux, dtype))
    want = _jengine(jprob, par_time, bsize).run(_j(g, dtype), iters,
                                                aux=_j(aux, dtype))
    assert got.dtype == prob.torch_dtype and tuple(got.shape) == \
        prob.state_shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(prob, iters))
    oracle = plan(prob, RunConfig(backend="reference", device="cpu")).run(
        _t(g, dtype), iters, aux=_t(aux, dtype))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(prob, iters))


@pytest.mark.parametrize("name,dims,bsize", [
    ("diffusion2d", (37, 53), 24), ("hotspot3d", (9, 21, 19), (12, 12))])
def test_engine_equals_port_oracle_bit_for_bit(name, dims, bsize):
    """Blocking reorders no cell's arithmetic: the engine is the oracle,
    with ``iters`` a multiple of ``par_time``, not one, and 0."""
    prob = StencilProblem(name, dims)
    g, aux = _data(prob, seed=4)
    eng = _engine(prob, 2, bsize)
    ref = plan(prob, RunConfig(backend="reference", device="cpu"))
    for iters in (4, 5, 0):
        assert torch.equal(eng.run(g, iters, aux=aux),
                           ref.run(g, iters, aux=aux))


@pytest.mark.parametrize("build,dims,bc,bsize", [
    (_single("hotspot2d"), (20, 40), ("periodic", "reflect"), 16),
    (_wave, (22, 19), "clamp", 8),
])
def test_engine_run_batch(build, dims, bc, bsize):
    """``run_batch`` with one aux grid shared and one per member: bit for
    bit the members' runs, within tolerance of ``repro``'s batch."""
    prob, jprob = _problems(build, dims, bc)
    g, aux = _data(prob, batch=3)
    p = _engine(prob, 2, bsize)
    jp = _jengine(jprob, 2, bsize)
    auxes = [aux]
    if aux is not None:
        auxes.append(np.stack([aux, aux * 2.0, aux * 0.5]))
    for a in auxes:
        got = p.run_batch(g, 5, aux=a)
        seq = [p.run(g[b], 5, aux=None if a is None else
                     (a[b] if a.ndim > len(dims) else a)) for b in range(3)]
        assert torch.equal(got, torch.stack(seq))
        np.testing.assert_allclose(
            _np(got), _np(jp.run_batch(_j(g), 5, aux=_j(a))),
            **_tol(prob, 5))


def test_engine_plan_rules():
    """The engine runs a row a tick: the model tunes V = 1 and a pinned
    ``par_vec > 1`` is refused; an unpinned schedule plans and runs."""
    prob = StencilProblem("diffusion2d", (16, 64))
    tuned = plan(prob, RunConfig(backend="engine", device="cpu"))
    assert tuned.candidates and all(c.geom.par_vec == 1
                                    for c in tuned.candidates)
    g, _ = _data(prob)
    assert torch.equal(tuned.run(g, 3), plan(prob, RunConfig(
        backend="reference", device="cpu")).run(g, 3))
    with pytest.raises(ValueError, match="par_vec=2 .* row a tick"):
        _engine(prob, 2, 16, par_vec=2)
    assert "engine" in japi.list_backends()
    assert _engine(prob, 2, 16, par_vec=1).geometry.par_vec == 1


def test_run_blocked_matches_reference():
    """``run_blocked``, the reference's one-call entry."""
    st, jst = stencils.DIFFUSION3D, jstencils.DIFFUSION3D
    jc = jstencils.default_coeffs(jst)
    tc = coeffs_from_reference(st, {k: np.asarray(v) for k, v in jc.items()})
    g = np.random.default_rng(5).uniform(0.5, 2, (8, 14, 14)).astype(
        np.float32)
    bc = ("clamp", "periodic", "reflect")
    got = engine.run_blocked(st, _t(g), tc, 5, 2, 10,
                             bc=BoundaryCondition.make(bc, 3))
    want = jengine.run_blocked(jst, _j(g), jc, 5, 2, 10,
                               bc=JBC.make(bc, 3))
    np.testing.assert_allclose(_np(got), _np(want),
                               **precision.tolerance("float32", 5))
