"""Stencils with a custom ``apply`` on the port's ``hopper`` backend, against
the reference package on the same numpy inputs.

Each custom stencil is written for both packages from one formula (with
``jnp`` and with ``torch`` where they differ).  The file holds the tracer
(``kernels/codegen.py``: the trace replayed by torch equals ``apply`` bit
for bit; the CUDA text; the refusals, ROADMAP B1i-ops), the ``hopper``
plain version against ``repro``'s ``pallas_interpret`` within
``repro.core.precision.tolerance`` (2D and 3D, the four boundary kinds,
float32 and bfloat16, ``par_vec`` 1 and 2, a batch), one super-step
against ``repro``'s interpret-mode ``superstep_dag``, and the generated
library's name."""
import asyncio

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
from repro_torch.api import RunConfig, StencilProblem, plan
from repro_torch.core import blocking, stencils
from repro_torch.kernels import _build, builder, codegen, ops

#: per package: (StencilStage, StencilProgram, stencils module, array
#: namespace)
PKGS = {"repro": (jprograms.StencilStage, jprograms.StencilProgram,
                  jstencils, jnp),
        "port": (programs.StencilStage, programs.StencilProgram, stencils,
                 torch)}


# --- the custom stencils, one formula for both packages ---------------------

def _lap2d(x):
    return x((-1, 0)) + x((1, 0)) + x((0, -1)) + x((0, 1)) - 4.0 * x((0, 0))


def _allen_cahn_apply(get, c, aux=None):
    """Phase-field (Allen-Cahn): ``u + dt*(d*lap(u) + u - u^3)``."""
    u = get((0, 0))
    return u + c["dt"] * (c["d"] * _lap2d(get) + u - u * u * u)


def _gray_scott_u(gets, c, aux=None):
    """Gray-Scott's u: ``u + dt*(Du*lap(u) - u*v*v + F*(1 - u))``."""
    u, v = gets[0]((0, 0)), gets[1]((0, 0))
    return u + c["dt"] * (c["Du"] * _lap2d(gets[0]) - u * v * v
                          + c["F"] * (1.0 - u))


def _gray_scott_v(gets, c, aux=None):
    """Gray-Scott's v: ``v + dt*(Dv*lap(v) + u*v*v - (F+k)*v)``."""
    v, u = gets[0]((0, 0)), gets[1]((0, 0))
    return v + c["dt"] * (c["Dv"] * _lap2d(gets[0]) + u * v * v
                          - c["Fk"] * v)


def _upwind_apply(xp):
    """First-order upwind transport along x with velocity ``aux``:
    ``u - dt*(max(a,0)*(u - u_w) + min(a,0)*(u_e - u))``."""
    if xp is torch:
        pos = lambda a: torch.clamp(a, min=0.0)        # noqa: E731
        neg = lambda a: torch.clamp(a, max=0.0)        # noqa: E731
    else:
        pos = lambda a: jnp.maximum(a, 0.0)            # noqa: E731
        neg = lambda a: jnp.minimum(a, 0.0)            # noqa: E731

    def apply(get, c, aux):
        u = get((0, 0, 0))
        return u - c["dt"] * (pos(aux) * (u - get((0, 0, -1)))
                              + neg(aux) * (get((0, 0, 1)) - u))
    return apply


def _stream1d_apply(get, c, aux=None):
    """tests/test_boundary_conditions.py's stream-only stencil."""
    return (c["c0"] * get((0, 0)) + c["cm"] * get((-1, 0))
            + c["cp"] * get((1, 0)))


def allen_cahn2d(S, P, st, xp):
    return [S(st.Stencil("allen_cahn2d", 2, 1, 12, 1, 1, False, ("dt", "d"),
                         _allen_cahn_apply), coeffs={"dt": 0.1, "d": 0.2})]


def gray_scott2d(S, P, st, xp):
    gs_u = st.Stencil("gs_u", 2, 1, 15, 2, 1, False, ("Du", "F", "dt"),
                      _gray_scott_u, arity=2)
    gs_v = st.Stencil("gs_v", 2, 1, 15, 2, 1, False, ("Dv", "Fk", "dt"),
                      _gray_scott_v, arity=2)
    return P((S(gs_u, name="un", inputs=("u", "v"),
                coeffs={"Du": 0.16, "F": 0.035, "dt": 1.0}),
              S(gs_v, name="vn", inputs=("v", "u"),
                coeffs={"Dv": 0.08, "Fk": 0.095, "dt": 1.0})),
             fields=("u", "v"), updates={"u": "un", "v": "vn"})


def upwind3d(S, P, st, xp):
    return [S(st.Stencil("upwind3d", 3, 1, 9, 2, 1, True, ("dt",),
                         _upwind_apply(xp)), coeffs={"dt": 0.3})]


def stream1d_in2d(S, P, st, xp):
    return [S(st.Stencil("stream1d_in2d", 2, 1, 5, 1, 1, False,
                         ("c0", "cm", "cp"), _stream1d_apply,
                         offsets=((0, 0), (-1, 0), (1, 0))),
              coeffs={"c0": 0.5, "cm": 0.25, "cp": 0.25})]


def custom_diamond(S, P, st, xp):
    """An Allen-Cahn stage beside a star, recombined: a custom stage in a
    DAG whose stages may differ in boundary."""
    ac = allen_cahn2d(S, P, st, xp)[0]
    return P((S(ac.stencil, name="a", inputs=("u",), coeffs=dict(ac.coeffs),
                boundary="reflect"),
              S(st.make_star(2, 1), name="b", inputs=("u",)),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4}, boundary="constant:0.5")))


def _problems(build, dims, bc="clamp", dtype="float32"):
    """(port problem, reference problem) of the same program."""
    return [mod(build(*PKGS[pkg]), dims, boundary=bc, dtype=dtype)
            for pkg, mod in (("port", StencilProblem),
                             ("repro", japi.StencilProblem))]


def _data(problem, seed=0):
    """Fields ``uniform(0, 1)``, the physical range of u and v, and a
    standard normal aux (a velocity), as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, problem.state_shape).astype(np.float32)
    aux = None
    if problem.needs_aux:
        aux = rng.standard_normal(problem.shape).astype(np.float32)
    return g, aux


def _j(x):
    return None if x is None else jnp.asarray(x)


# --- the tracer --------------------------------------------------------------

def _port_stencils(build):
    prog = build(*PKGS["port"])
    stages = prog.stages if isinstance(prog, programs.StencilProgram) else prog
    return [s.stencil for s in stages]


def _real_inputs(st, rng, shape=(6, 7, 8)):
    """Random getters (one per input), coefficients and aux for ``st``: a
    tap at ``off`` is the input's tensor rolled by it."""
    shape = shape[:st.ndim]
    fields = [torch.from_numpy(rng.uniform(0.1, 1.0, shape)
                               .astype(np.float32))
              for _ in range(st.arity)]

    def getter(f):
        return lambda off: torch.roll(f, tuple(-d for d in off),
                                      tuple(range(st.ndim)))
    gets = tuple(getter(f) for f in fields)
    coeffs = {n: torch.tensor(rng.uniform(0.1, 0.9), dtype=torch.float32)
              for n in st.coeff_names}
    aux = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
           if st.has_aux else None)
    return gets if st.arity > 1 else gets[0], coeffs, aux


def _random_apply(seed: int):
    """A seeded random expression tree over the ops the tracer lowers, as
    an ``apply`` of a 2D radius-1 stencil of two inputs with aux."""
    rng = np.random.default_rng(seed)
    offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (1, 1)]

    def draw(depth):
        r = rng.integers(0, 4 if depth > 3 else 16)
        if r == 0:
            return ("tap", int(rng.integers(0, 2)),
                    offs[rng.integers(0, len(offs))])
        if r == 1:
            return ("coef", ("a", "b", "k")[rng.integers(0, 3)])
        if r == 2:
            return ("const", float(rng.uniform(-2.0, 2.0)))
        if r == 3:
            return ("aux",)
        op = ("add", "sub", "mul", "div", "neg", "abs", "pow", "max", "min",
              "where", "clamp", "rsub", "rdiv")[(r - 4) % 13]
        if op == "pow":
            return (op, int(rng.choice([2, 3, -1, -2])), draw(depth + 1))
        return (op,) + tuple(draw(depth + 1) for _ in range(
            {"neg": 1, "abs": 1, "clamp": 1, "where": 4}.get(op, 2)))
    # the root always reads a tap, so the result is one value per cell
    root = ("add", ("tap", 0, (0, 0)), draw(0))

    def ev(node, gets, c, aux):
        op, args = node[0], node[1:]
        if op == "tap":
            return gets[args[0]](args[1])
        if op == "coef":
            return c[args[0]]
        if op == "const":
            return args[0]
        if op == "aux":
            return aux
        if op == "pow":     # a negative power of a value >= 1
            x = ev(args[1], gets, c, aux)
            x = x if isinstance(x, float) or args[0] > 0 else abs(x) + 1.0
            return (x if not isinstance(x, float)
                    else gets[0]((0, 0)) * x) ** args[0]
        a = [ev(x, gets, c, aux) for x in args]

        def tensor(x):      # maximum, minimum and where take a value
            return x if not isinstance(x, float) else gets[0]((0, 0)) * x
        if op == "add":
            return a[0] + a[1]
        if op == "sub":
            return a[0] - a[1]
        if op == "rsub":
            return 1.5 - tensor(a[0]) + a[1]
        if op == "mul":
            return a[0] * a[1]
        if op == "div":
            return a[0] / (abs(tensor(a[1])) + 1.0)
        if op == "rdiv":
            return 2.0 / (abs(tensor(a[0])) + 1.0) + a[1]
        if op == "neg":
            return -tensor(a[0])
        if op == "abs":
            return abs(tensor(a[0]))
        if op == "max":
            return torch.maximum(tensor(a[0]), tensor(a[1]))
        if op == "min":
            return torch.minimum(tensor(a[0]), tensor(a[1]))
        if op == "clamp":
            return torch.clamp(tensor(a[0]), min=-0.5, max=1.5)
        return torch.where(tensor(a[0]) > tensor(a[1]), tensor(a[2]),
                           tensor(a[3]))

    def apply(gets, c, aux):
        return ev(root, gets, c, aux)
    return stencils.Stencil(f"random{seed}", 2, 1, 1, 3, 1, True,
                            ("a", "b", "k"), apply, arity=2)


CELLS = {"allen_cahn2d": allen_cahn2d, "gray_scott2d": gray_scott2d,
         "upwind3d": upwind3d, "stream1d_in2d": stream1d_in2d}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_trace_replays_apply_bit_for_bit(name):
    """The trace, replayed with torch, equals ``apply`` bit for bit."""
    rng = np.random.default_rng(0)
    for st in _port_stencils(CELLS[name]):
        tr = codegen.trace(st)
        args = _real_inputs(st, rng)
        want = st.apply(*args)
        got = codegen.evaluate(codegen.trace(st), *args)
        assert got.dtype == torch.float32 and tr.arity == st.arity
        assert torch.equal(got, want), st.name


@pytest.mark.parametrize("seed", range(20))
def test_random_expression_traces_replay_bit_for_bit(seed):
    """Twenty seeded random expression trees over ``+ - * /``, reflected
    operands, neg, abs, powers, maximum, minimum, clamp and where: the
    trace replays ``apply`` bit for bit, and the CUDA text holds one
    ``const`` per value the result depends on."""
    st = _random_apply(seed)
    tr = codegen.trace(st)
    args = _real_inputs(st, np.random.default_rng(seed))
    assert torch.equal(codegen.evaluate(tr, *args), st.apply(*args))
    text = codegen.device_function(tr, 0)
    assert text.count("\n  const ") == sum(codegen._live(tr))


def test_transcendentals_and_powers_replay_bit_for_bit():
    def apply(get, c, aux=None):
        u = get((0, 0))
        return (torch.exp(-u) + u.log() + torch.sqrt(u) + torch.tanh(u)
                + torch.sin(u) * u.cos() + u ** 3 + u ** -1 + u ** -2
                + u ** 0 + u ** 1 + 2.0 / u)
    st = stencils.Stencil("tr", 2, 1, 1, 1, 1, False, (), apply)
    args = _real_inputs(st, np.random.default_rng(3))
    tr = codegen.trace(st)
    assert torch.equal(codegen.evaluate(tr, *args), st.apply(*args))
    text = codegen.device_function(tr, 0)
    for call in ("expf(", "logf(", "sqrtf(", "tanhf(", "sinf(", "cosf("):
        assert call in text
    # u ** 3 as torch's pow kernels form it: (u * u) * u
    assert "__fmul_rn(__fmul_rn(v0, v0), v0)" in text


ALLEN_CAHN_CUDA = """\
// allen_cahn2d: 2D, radius 1, arity 1, coefficients dt, d
template <class G, class A>
__device__ __forceinline__ float fn0(const G& g, const float* c, const A& aux) {
  const float v0 = g(0, 0, 0, 0);
  const float v1 = c[0];
  const float v2 = c[1];
  const float v3 = g(0, -1, 0, 0);
  const float v4 = g(0, 1, 0, 0);
  const float v5 = __fadd_rn(v3, v4);
  const float v6 = g(0, 0, 0, -1);
  const float v7 = __fadd_rn(v5, v6);
  const float v8 = g(0, 0, 0, 1);
  const float v9 = __fadd_rn(v7, v8);
  const float v10 = 0x1.0000000000000p+2f;
  const float v11 = __fmul_rn(v0, v10);
  const float v12 = __fsub_rn(v9, v11);
  const float v13 = __fmul_rn(v2, v12);
  const float v14 = __fadd_rn(v13, v0);
  const float v15 = __fmul_rn(v0, v0);
  const float v16 = __fmul_rn(v15, v0);
  const float v17 = __fsub_rn(v14, v16);
  const float v18 = __fmul_rn(v1, v17);
  const float v19 = __fadd_rn(v0, v18);
  return v19;
}"""


def test_allen_cahn_cuda_text_is_torch_order():
    """The emitted device function of allen_cahn2d: deterministic, one
    rounding per op in the order torch evaluates ``apply`` (the Laplacian
    left to right, ``4.0 * u`` as torch's reflected mul, ``u*u*u`` as
    ``(u*u)*u``); the program header switches over it."""
    st = _port_stencils(allen_cahn2d)[0]
    assert codegen.device_function(codegen.trace(st), 0) == ALLEN_CAHN_CUDA
    header = codegen.program_header([codegen.trace(st)])
    assert ALLEN_CAHN_CUDA in header and "custom_apply(int fn" in header
    assert header == codegen.program_header([codegen.trace(st)])


def test_division_by_a_scalar_is_a_reciprocal_product():
    """A per-cell value over a coefficient or constant multiplies by the
    scalar's reciprocal (torch's CUDA division by a CPU scalar); over a
    per-cell value it divides; ``a / u`` is torch's ``reciprocal(u) * a``."""
    st = stencils.Stencil("divs", 2, 1, 1, 1, 1, False, ("k",),
                          lambda get, c, aux=None: get((0, 0)) / c["k"]
                          + get((0, 1)) / 4.0 + get((1, 0)) / get((0, 0))
                          + 3.0 / get((0, -1)) + c["k"] / get((-1, 0)))
    text = codegen.device_function(codegen.trace(st), 0)
    assert text.count("__fdiv_rn(1.0f, v1)") == 1        # / c["k"]
    assert "__fmul_rn(v0, __fdiv_rn(1.0f, v1))" in text
    assert "__fdiv_rn(1.0f, v4)" in text                 # / 4.0
    assert "__fdiv_rn(v7, v0)" in text                   # / get((0, 0))
    assert "__fdiv_rn(1.0f, v10)" in text                # 3.0 / get
    assert "__fdiv_rn(v1, v15)" in text                  # c / get
    args = _real_inputs(st, np.random.default_rng(5))
    assert torch.equal(codegen.evaluate(codegen.trace(st), *args),
                       st.apply(*args))


REFUSALS = {
    "branch": (lambda get, c, aux=None: get((0, 0)) if get((0, 1)) > 0
               else get((0, -1)), "branches on a traced value"),
    "python_min": (lambda get, c, aux=None: min(get((0, 0)), get((0, 1))),
                   "branches on a traced value"),
    "unlowered_op": (lambda get, c, aux=None: torch.sigmoid(get((0, 0))),
                     "calls sigmoid"),
    "unlowered_method": (lambda get, c, aux=None: get((0, 0)).sigmoid(),
                         "uses .sigmoid"),
    "power": (lambda get, c, aux=None: get((0, 0)) ** 0.5, r"\*\* 0.5"),
    "alpha": (lambda get, c, aux=None: torch.add(get((0, 0)), get((0, 1)),
                                                 alpha=2.0), "calls add"),
    "outside_radius": (lambda get, c, aux=None: get((0, 2)),
                       "outside its radius 1"),
    "wrong_rank": (lambda get, c, aux=None: get((0, 0, 0)),
                   "on a 2D stencil"),
    "comparison": (lambda get, c, aux=None: get((0, 0)) > 1.0,
                   "returns a comparison"),
    "coefficients_only": (lambda get, c, aux=None: c["k"] * 2.0,
                          "of the coefficients only"),
    "number": (lambda get, c, aux=None: 1.0, "returns float"),
    "tuple": (lambda get, c, aux=None: (get((0, 0)), get((0, 1))),
              "returns tuple"),
    "unknown_coefficient": (lambda get, c, aux=None: c["q"] * get((0, 0)),
                            "coefficient 'q'"),
    "host_math": (lambda get, c, aux=None: float(get((0, 0))) + get((0, 1)),
                  "the tracer"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unlowerable_apply_is_refused_by_name(case):
    """What cannot be lowered is refused, at plan time and by
    ``stage_op``, as ROADMAP B1i-ops, with its reason."""
    apply, reason = REFUSALS[case]
    st = stencils.Stencil("bad2d", 2, 1, 1, 1, 1, False, ("k",), apply)
    with pytest.raises(ValueError, match=reason):
        codegen.trace(st)
    with pytest.raises(ValueError, match="B1i-ops"):
        builder.stage_op(st)
    with pytest.raises(ValueError, match=f"stage 'bad2d'.*B1i-ops"):
        plan(StencilProblem(programs.StencilStage(st, coeffs={"k": 1.0}),
                            (16, 32)),
             RunConfig(backend="hopper", par_time=2, bsize=16,
                       device="cpu"))


def test_library_is_named_by_the_generated_text():
    """Two custom stencils of one name and different ``apply`` get two
    libraries; the same program at another form, dtype or batch mode gets
    another, and the same one the same."""
    def stage(apply):
        return programs.StencilStage(
            stencils.Stencil("same", 2, 1, 1, 1, 1, False, ("k",), apply),
            coeffs={"k": 0.5})
    problems = [StencilProblem(stage(f), (16, 40)) for f in (
        lambda get, c, aux=None: c["k"] * get((0, 1)),
        lambda get, c, aux=None: c["k"] * get((0, -1)))]
    geoms = [plan(p, RunConfig(backend="hopper", par_time=2, bsize=16,
                               par_vec=v, device="cpu")).geometry
             for p, v in zip(problems, (1, 1))]
    keys = [builder._custom_build(p.exec_dag, g, False, False)
            for p, g in zip(problems, geoms)]
    paths = [_build.custom_library_path(*k) for k in keys]
    assert paths[0] != paths[1] and keys[0][1] == keys[1][1]
    assert paths[0].name.startswith("libstencil_custom_")
    assert "same" not in paths[0].name
    v2 = plan(problems[0], RunConfig(backend="hopper", par_time=2, bsize=16,
                                     par_vec=2, device="cpu")).geometry
    others = [builder._custom_build(problems[0].exec_dag, v2, False, False),
              builder._custom_build(problems[0].exec_dag, geoms[0], True,
                                    False),
              builder._custom_build(problems[0].exec_dag, geoms[0], False,
                                    True)]
    assert len({_build.custom_library_path(*k) for k in others}
               | {paths[0]}) == 4
    assert builder._custom_build(problems[0].exec_dag, geoms[0], False,
                                 False) == keys[0]
    # a program of the shared stencils needs no library of its own
    plain = StencilProblem("diffusion2d", (16, 40))
    assert builder._custom_build(plain.exec_dag, geoms[0], False,
                                 False) is None


def test_custom_stage_tables_hold_the_function_index():
    """A custom stage's op is CUSTOM_OP and its tap range holds its
    function index in the program's header; stages of one stencil share
    it."""
    prob = StencilProblem(gray_scott2d(*PKGS["port"]), (16, 40),
                          boundary="periodic")
    geom = plan(prob, RunConfig(backend="hopper", par_time=2, bsize=16,
                                device="cpu")).geometry
    dag = prob.exec_dag
    c = ops.pack_dag_coeffs(dag, prob.resolve_coeffs())
    table, _, _ = builder._dag_table(dag, geom, c)
    assert [table.s[i].op for i in range(2)] == [builder.CUSTOM_OP] * 2
    assert [table.s[i].tap_lo for i in range(2)] == [0, 1]
    assert [table.s[i].tap_n for i in range(2)] == [0, 0]
    pairs = [(st, bc) for st, bc, _ in dag.stages]
    assert builder.custom_stencils(pairs + pairs) == tuple(
        st for st, _ in pairs)


# --- the hopper plain version against pallas_interpret -----------------------

#: (cell, program, dims, boundary, dtype, par_time, bsize, par_vec, iters)
PLANS = [
    ("allen_cahn2d", allen_cahn2d, (24, 40), "clamp", "float32", 2, 16, 1,
     5),
    ("allen_cahn2d_reflect_v2", allen_cahn2d, (23, 40), "reflect",
     "float32", 2, 16, 2, 5),
    ("allen_cahn2d_bf16", allen_cahn2d, (24, 40), "clamp", "bfloat16", 2, 16,
     1, 5),
    ("gray_scott2d", gray_scott2d, (20, 36), "periodic", "float32", 2, 16, 1,
     5),
    ("gray_scott2d_constant_v2", gray_scott2d, (21, 36), "constant:0.0",
     "float32", 2, 16, 2, 5),
    ("upwind3d", upwind3d, (12, 20, 20), "clamp", "float32", 2, (8, 8), 1,
     5),
    ("upwind3d_periodic_bf16", upwind3d, (12, 20, 20), "periodic",
     "bfloat16", 2, (8, 8), 1, 5),
    ("stream1d_in2d_periodic", stream1d_in2d, (19, 33), "periodic",
     "float32", 2, 16, 1, 5),
    ("stream1d_in2d_constant", stream1d_in2d, (19, 33), "constant:0.6",
     "float32", 2, 16, 1, 5),
    ("custom_diamond", custom_diamond, (20, 36), "clamp", "float32", 2, 16,
     1, 5),
]


def _plans(case):
    _, build, dims, bc, dtype, T, bsize, V, iters = case
    mine, want = _problems(build, dims, bc, dtype)
    return mine, want, T, bsize, V, iters


def _tol(problem, iters):
    return jprecision.tolerance(problem.dtype, iters,
                                stages=problem.n_stages)


@pytest.mark.parametrize("case", PLANS, ids=lambda c: c[0])
def test_hopper_custom_matches_pallas_interpret(case):
    """``plan(..., RunConfig(backend="hopper", device="cpu"))`` against
    ``repro``'s ``pallas_interpret`` at the same schedule, within
    ``tolerance(dtype, iters, stages)``."""
    mine, want, T, bsize, V, iters = _plans(case)
    g, aux = _data(mine, seed=1)
    got = plan(mine, RunConfig(backend="hopper", par_time=T, bsize=bsize,
                               par_vec=V, device="cpu")).run(g, iters,
                                                             aux=aux)
    assert tuple(got.shape) == mine.state_shape
    assert got.dtype == mine.torch_dtype
    pallas = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=T, bsize=bsize,
        par_vec=V)).run(jnp.asarray(g).astype(want.jnp_dtype), iters,
                        aux=None if aux is None
                        else jnp.asarray(aux).astype(want.jnp_dtype))
    conf.assert_close(got.float(), np.asarray(pallas, np.float32),
                      _tol(mine, iters))


def test_hopper_custom_run_batch_equals_runs():
    """A batch of 2 (a velocity per member) equals its members' runs bit
    for bit."""
    mine, _ = _problems(upwind3d, (12, 20, 20))
    p = plan(mine, RunConfig(backend="hopper", par_time=2, bsize=(8, 8),
                             device="cpu"))
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.uniform(0, 1, (2, 12, 20, 20))
                         .astype(np.float32))
    aux = torch.from_numpy(rng.standard_normal((2, 12, 20, 20))
                           .astype(np.float32))
    got = p.run_batch(g, 5, aux=aux)
    for b in range(2):
        assert torch.equal(got[b], p.run(g[b], 5, aux=aux[b]))


@pytest.mark.parametrize("name", ["allen_cahn2d", "gray_scott2d",
                                  "upwind3d", "custom_diamond"])
def test_plain_custom_superstep_matches_pallas_interpret(name):
    """``superstep_dag_plain`` against ``repro``'s ``superstep_dag(...,
    interpret=True)`` on the same padded input, on the grid's cells, with
    ``steps = par_time`` and ``par_time - 1``."""
    case = next(c for c in PLANS if c[0] == name)
    mine, want, T, bsize, _, _ = _plans(case)
    geom = plan(mine, RunConfig(backend="hopper", par_time=T, bsize=bsize,
                                device="cpu")).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=T, bsize=bsize,
        par_vec=1)).geometry
    bc0 = mine.structural_bc
    g, aux = _data(mine, seed=2)
    gp = ops._pad_blocked(torch.from_numpy(g), geom, bc0)
    jgp = jops._pad_blocked(jnp.asarray(g), jgeom, want.structural_bc)
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
    cells = ((Ellipsis, slice(ext, ext + mine.shape[0]))
             + tuple(slice(h, h + d) for d in mine.shape[1:]))
    for steps in (T, T - 1):
        got = builder.superstep_dag_plain(mine.exec_dag, geom, gp, c, steps,
                                          aux_p, torch.empty_like(gp))
        exp = jbuilder.superstep_dag(
            want.exec_dag, jgeom, jgp, jc, jnp.asarray(steps, jnp.int32),
            jaux_p, interpret=True)
        conf.assert_close(got[cells], np.asarray(exp)[cells],
                          _tol(mine, steps))


def test_service_serves_a_custom_stencil():
    """A ``StencilService`` bucket of a custom stencil serves as any other:
    a batch of three requests, each equal to its ``plan.run`` bit for
    bit."""
    from repro_torch.serve import (BucketConfig, ServiceConfig,
                                   StencilRequest, StencilService)
    mine, _ = _problems(allen_cahn2d, (12, 32))
    run = RunConfig(backend="hopper", par_time=2, bsize=16, device="cpu")
    cfg = ServiceConfig(buckets=(BucketConfig(
        problem=mine, run=run, max_batch=4, max_wait_ms=20.0),))
    grids = [_data(mine, seed=s)[0] for s in range(3)]

    async def serve():
        async with StencilService(cfg) as svc:
            return await asyncio.gather(*(
                svc.submit(StencilRequest(mine, g, 3)) for g in grids))
    results = asyncio.run(asyncio.wait_for(serve(), 60))
    p = plan(mine, run)
    for g, res in zip(grids, results):
        assert res.batch_size == 3 and res.batch_fill == 0.75
        assert torch.equal(res.grid, p.run(g, 3))
