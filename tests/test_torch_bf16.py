"""bfloat16 storage with float32 arithmetic on the ``hopper`` backend
against the reference package on the same numpy inputs: the plain version
of the streaming kernel (all three bodies) in bf16 against ``repro``'s
``pallas_interpret`` and ``reference`` backends in bf16 — the four Table-2
stencils in 2D and 3D at V in {1, 2, 4}, clamp and periodic, the 1D
``star1d_r2``, a star/box chain, the wave and diamond DAGs and a Hotspot
DAG — one bf16 super-step against ``repro``'s ``superstep_chain``/
``superstep_dag(..., interpret=True)``, the ring pricing at 2 bytes a cell
and the plans it admits.  Tolerances are ``repro.core.precision.tolerance(
"bfloat16", iters, stages)``.
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
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking
from repro_torch.core import stencils
from repro_torch.kernels import builder, ops

torch.set_num_threads(1)

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (japi.StencilStage, japi.StencilProgram, jstencils),
        "port": (StencilStage, StencilProgram, stencils)}
BF16 = "bfloat16"


def _single(name):
    return lambda S, P, st: name


def _star_box(S, P, st):
    return [S(st.make_star(2, 2)), S(st.make_box(2, 1))]


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


def _hotspot_dag(S, P, st):
    return P((S("hotspot2d", name="h", inputs=("u",)),
              S(st.make_combine(2, 3), name="m", inputs=("h", "u", "v"),
                coeffs={"w0": 0.5, "w1": 0.3, "w2": 0.2})),
             fields=("u", "v"), updates={"u": "m", "v": "u"})


def _problems(build, dims, bc, dtype=BF16):
    """(port problem, reference problem) of the same program."""
    return (StencilProblem(build(*PKGS["port"]), dims, boundary=bc,
                           dtype=dtype),
            japi.StencilProblem(build(*PKGS["repro"]), dims, boundary=bc,
                                dtype=dtype))


def _data(problem, seed=0):
    """float32 numpy state and aux; each side rounds them to bf16."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.uniform(0.0, 0.1, problem.shape).astype(np.float32)
    return g, aux


def _t(x):
    return None if x is None else torch.from_numpy(x).to(torch.bfloat16)


def _j(x):
    return None if x is None else jnp.asarray(x, jnp.bfloat16)


def _np(x):
    """A bf16 result of either package as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _tol(problem, iters):
    return jprecision.tolerance(BF16, iters, stages=problem.n_stages,
                                scale=100 if problem.needs_aux else None)


def _hopper(problem, par_time, bsize, V=1):
    return plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, par_vec=V, device="cpu"))


#: (build, dims, boundary, par_time, bsize, par_vec, iters, reference
#: backend): stream extents that V does and does not divide
CASES = [
    (_single("diffusion2d"), (29, 40), "clamp", 2, 16, 1, 5,
     "pallas_interpret"),
    (_single("diffusion2d"), (29, 40), "periodic", 2, 16, 2, 5,
     "pallas_interpret"),
    (_single("hotspot2d"), (13, 33), "clamp", 2, 16, 4, 5,
     "pallas_interpret"),
    (_single("hotspot2d"), (13, 33), "periodic", 3, 16, 1, 7, "reference"),
    (_single("diffusion3d"), (9, 20, 20), "clamp", 2, (10, 10), 2, 5,
     "pallas_interpret"),
    (_single("diffusion3d"), (9, 20, 20), "periodic", 2, (10, 10), 4, 5,
     "reference"),
    (_single("hotspot3d"), (9, 20, 20), "clamp", 2, (10, 10), 4, 5,
     "pallas_interpret"),
    (_single("hotspot3d"), (9, 20, 20), ("clamp", "periodic", "periodic"),
     2, (10, 10), 1, 5, "reference"),
    (_single("star1d_r2"), (101,), "clamp", 3, (), 4, 7, "pallas_interpret"),
    (_star_box, (24, 32), "clamp", 2, 16, 2, 5, "pallas_interpret"),
    (_wave, (22, 19), "periodic", 2, 8, 1, 5, "pallas_interpret"),
    (_diamond, (21, 40), "clamp", 2, 16, 2, 5, "pallas_interpret"),
    (_hotspot_dag, (17, 30), ("clamp", "periodic"), 3, 16, 1, 7,
     "reference"),
]


def _case_id(case):
    build, dims, bc, _, _, V, _, backend = case
    name = build(*PKGS["port"])
    name = name if isinstance(name, str) else build.__name__.strip("_")
    bc = bc if isinstance(bc, str) else "-".join(bc)
    return f"{name}-{'x'.join(map(str, dims))}-{bc}-V{V}-{backend}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bf16_hopper_matches_reference_package(case):
    """The plain version in bf16 returns bf16 and agrees with ``repro`` in
    bf16 within ``tolerance("bfloat16", iters, stages)``."""
    build, dims, bc, par_time, bsize, V, iters, backend = case
    mine, want = _problems(build, dims, bc)
    g, aux = _data(mine)
    got = _hopper(mine, par_time, bsize, V).run(_t(g), iters, aux=_t(aux))
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == mine.state_shape
    cfg = {} if backend == "reference" else dict(
        par_time=par_time, bsize=bsize, par_vec=V)
    exp = japi.plan(want, japi.RunConfig(backend=backend, **cfg)).run(
        _j(g), iters, aux=_j(aux))
    np.testing.assert_allclose(_np(got), _np(exp), **_tol(mine, iters))


#: id -> (build, dims, boundary, par_time, bsize, par_vec)
SUPERSTEPS = {
    "hotspot2d": (_single("hotspot2d"), (13, 33), "clamp", 2, 16, 1),
    "star_box_v4": (_star_box, (24, 32), "clamp", 2, 16, 4),
    "wave_periodic": (_wave, (22, 19), "periodic", 2, 8, 1),
}


@pytest.mark.parametrize("name", sorted(SUPERSTEPS))
def test_bf16_superstep_matches_interpret_kernel(name):
    """One bf16 super-step of the plain version against ``repro``'s
    ``superstep_chain``/``superstep_dag(..., interpret=True)`` on the same
    bf16 padded input, with and without forwarding, on the grid's cells."""
    build, dims, bc, par_time, bsize, V = SUPERSTEPS[name]
    mine, want = _problems(build, dims, bc)
    geom = _hopper(mine, par_time, bsize, V).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=V)).geometry
    bc0 = mine.structural_bc
    g, aux = _data(mine, seed=2)
    gp = ops._pad_blocked(_t(g), geom, bc0)
    jgp = jops._pad_blocked(_j(g), jgeom, want.structural_bc)
    assert gp.dtype == torch.bfloat16 and tuple(gp.shape) == jgp.shape
    aux_p = None if aux is None else ops._pad_blocked(_t(aux), geom, bc0)
    jaux_p = (None if aux is None
              else jops._pad_blocked(_j(aux), jgeom, want.structural_bc))
    c = ops.pack_dag_coeffs(mine.exec_dag, mine.resolve_coeffs())
    jc = jops.pack_dag_coeffs(want.exec_dag,
                              want.resolve_coeffs(dtype=jnp.float32))
    ext = blocking.stream_extension(geom, bc0)
    h = geom.size_halo
    cells = ((Ellipsis, slice(ext, ext + dims[0]))
             + tuple(slice(h, h + d) for d in dims[1:]))
    for steps in (par_time, par_time - 1):
        js = jnp.asarray(steps, jnp.int32)
        got = builder.superstep_dag(mine.exec_dag, geom, gp, c, steps, aux_p)
        assert got.dtype == torch.bfloat16
        if mine.is_dag:
            exp = jbuilder.superstep_dag(want.exec_dag, jgeom, jgp, jc, js,
                                         jaux_p, interpret=True)
        else:
            exp = jbuilder.superstep_chain(want.exec_stages, jgeom, jgp, jc,
                                           js, jaux_p, interpret=True)
        np.testing.assert_allclose(_np(got[cells]), _np(exp[cells]),
                                   **_tol(mine, steps))


@pytest.mark.parametrize("build,dims,bc,bsize,V", [
    (_single("diffusion2d"), (64, 600), "clamp", (256,), 8),
    (_single("hotspot3d"), (16, 64, 64), "clamp", (32, 32), 4),
    (_wave, (64, 600), "periodic", (256,), 4),
])
def test_bf16_rings_take_half_the_bytes(build, dims, bc, bsize, V):
    """The rings are priced at the storage cell: 2 bytes in bf16, half of
    float32, in ``smem_bytes`` and in the traffic report; the device-memory
    bytes halve too."""
    f32, _ = _problems(build, dims, bc, "float32")
    bf16, _ = _problems(build, dims, bc)
    a = _hopper(f32, 4, bsize, V).traffic_report(8)
    b = _hopper(bf16, 4, bsize, V).traffic_report(8)
    geom = _hopper(bf16, 4, bsize, V).geometry
    assert b["smem_bytes"] * 2 == a["smem_bytes"] == blocking.smem_bytes(
        geom, f32.exec_dag, 4)
    assert b["smem_bytes"] == blocking.smem_bytes(geom, bf16.exec_dag, 2)
    assert b["kernel_dma_bytes_per_superstep"] * 2 == \
        a["kernel_dma_bytes_per_superstep"]


def test_bf16_admits_the_2d_v16_plan():
    """2D ``bsize=256`` at T=8 and V=16 needs 393,216 bytes of rings in
    float32, over the 232,448 a CTA has, and 196,608 in bf16."""
    with pytest.raises(ValueError, match="393216 bytes of shared memory"):
        _hopper(StencilProblem("diffusion2d", (64, 9000)), 8, 256, 16)
    p = _hopper(StencilProblem("diffusion2d", (64, 9000), dtype=BF16), 8,
                256, 16)
    assert p.traffic_report()["smem_bytes"] == 196608
    limit = builder.kernel_limits(p.geometry, p.problem.exec_dag, 2)
    assert limit is None


def test_bf16_superstep_checks_its_tensors():
    """``gp``, ``aux_p`` and ``out`` share one storage dtype; the
    coefficients stay a float32 CPU vector."""
    st = stencils.HOTSPOT2D
    geom = blocking.BlockGeometry(2, (8, 40), 1, 2, (16,))
    gp = torch.zeros((8,) + geom.padded_dims, dtype=torch.bfloat16)
    c = ops.pack_coeffs(st, stencils.default_coeffs(st))
    aux_p = torch.zeros_like(gp)
    out = builder.superstep_chain(((st, None),), geom, gp, c, 2, aux_p)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="aux_p"):
        builder.superstep_chain(((st, None),), geom, gp, c, 2, aux_p.float())
    with pytest.raises(ValueError, match="out"):
        builder.superstep_chain(((st, None),), geom, gp, c, 2, aux_p,
                                out=torch.empty_like(gp, dtype=torch.float32))
    with pytest.raises(ValueError, match="float32 CPU vector"):
        builder.superstep_chain(((st, None),), geom, gp, c.bfloat16(), 2,
                                aux_p)
