"""The port's batched path (B1f, A9): ``StencilPlan.run_batch`` as one
launch per super-step for the whole batch, ``prewarm``, and
``run(checkpoint_every=...)``, on the CPU through the kernel's plain
version.  ``run_batch`` against ``repro``'s ``pallas_interpret``
``run_batch`` on the same numpy inputs within
``repro.core.precision.tolerance`` (never bitwise: ``repro``'s own
``reference`` ``run_batch`` misses its sequential runs by 2 ulps); against
the port's own sequential ``run``s bit for bit, on ``hopper`` and
``reference``; one batched ``superstep_dag`` against ``B`` single ones bit
for bit on all three bodies; the refusals, by name."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance  # noqa: F401 — one thread, as the other files
from repro import api as japi
from repro import programs as jprograms
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan, register_backend)
from repro_torch.api.backends import _REGISTRY
from repro_torch.core import stencils
from repro_torch.kernels import _build, builder, ops
from repro_torch.kernels.ref import oracle_run

DIMS2 = (12, 20)
DIMS3 = (7, 19, 17)
B = 3

#: per package: (StencilStage, StencilProgram, stencils module)
PKGS = {"repro": (jprograms.StencilStage, jprograms.StencilProgram,
                  jstencils),
        "port": (StencilStage, StencilProgram, stencils)}


def _single(name):
    return lambda S, P, st: name


def _chain(S, P, st):
    """``star2d_r1`` with advect coefficients, then ``diffusion2d``."""
    return [S(st.make_star(2, 1), name="advect",
              coeffs={"c0": 0.7, "c_0_-1": 0.1, "c_0_1": 0.0,
                      "c_1_-1": 0.2, "c_1_1": 0.0}),
            S("diffusion2d")]


def _wave(S, P, st):
    lap = {"c0": -4.0, "c_0_-1": 1.0, "c_0_1": 1.0, "c_1_-1": 1.0,
           "c_1_1": 1.0}
    return P((S(st.make_star(2, 1), coeffs=lap, name="lapu", inputs=("u",)),
              S(st.make_combine(2, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.1})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _problems(build, dims, bc="clamp", dtype="float32"):
    """(port problem, reference problem) of the same program."""
    return (StencilProblem(build(*PKGS["port"]), dims, boundary=bc,
                           dtype=dtype),
            japi.StencilProblem(build(*PKGS["repro"]), dims, boundary=bc,
                                dtype=dtype))


def _batch(problem, seed=0, aux="batched"):
    """``B`` float32 numpy states and, for Hotspot, an aux batch
    (``"batched"``) or one shared grid (``"shared"``)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, (B,) + problem.state_shape).astype(np.float32)
    a = None
    if problem.needs_aux:
        shape = ((B,) if aux == "batched" else ()) + problem.shape
        a = rng.uniform(0.0, 0.1, shape).astype(np.float32)
    return g, a


def _hopper(problem, par_time=2, bsize=16, device="cpu"):
    return plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, device=device))


def _as(x, dtype):
    if x is None:
        return None, None
    if dtype == "bfloat16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x, jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


#: id -> (build, dims, boundary, dtype, par_time, bsize, aux mode, iters)
CASES = {
    "diffusion2d": (_single("diffusion2d"), DIMS2, "clamp", "float32", 2, 16,
                    None, 5),
    "hotspot2d-batched-aux": (_single("hotspot2d"), DIMS2, "clamp",
                              "float32", 2, 16, "batched", 5),
    "hotspot2d-shared-aux": (_single("hotspot2d"), DIMS2, "clamp", "float32",
                             2, 16, "shared", 4),
    "hotspot3d-batched-aux": (_single("hotspot3d"), DIMS3, "clamp",
                              "float32", 2, (12, 12), "batched", 5),
    "diffusion3d-shared": (_single("diffusion3d"), DIMS3, "clamp", "float32",
                           2, (12, 12), None, 5),
    "chain": (_chain, (24, 32), "clamp", "float32", 2, 16, None, 5),
    "wave-periodic": (_wave, (22, 19), "periodic", "float32", 2, 8, None, 5),
    "diffusion2d-bf16": (_single("diffusion2d"), DIMS2, "clamp", "bfloat16",
                         2, 16, None, 5),
    "diffusion2d-reflect": (_single("diffusion2d"), DIMS2, "reflect",
                            "float32", 2, 16, None, 5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_batch_matches_reference_package(name):
    """The port's ``run_batch`` (one batched launch per super-step; its
    plain version here) against ``repro``'s ``pallas_interpret``
    ``run_batch`` on the same inputs, within ``tolerance(dtype, iters,
    stages)``."""
    build, dims, bc, dtype, par_time, bsize, aux_mode, iters = CASES[name]
    mine, want = _problems(build, dims, bc, dtype)
    g, aux = _batch(mine, aux=aux_mode or "batched")
    (tg, jg), (ta, ja) = _as(g, dtype), _as(aux, dtype)
    got = _hopper(mine, par_time, bsize).run_batch(tg, iters, aux=ta)
    assert tuple(got.shape) == (B,) + mine.state_shape
    assert got.dtype == mine.torch_dtype
    exp = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=par_time, bsize=bsize,
        par_vec=1)).run_batch(jg, iters, aux=ja)
    np.testing.assert_allclose(_np(got), _np(exp), **jprecision.tolerance(
        dtype, iters, stages=mine.n_stages,
        scale=100 if mine.needs_aux else None))


@pytest.mark.parametrize("backend", ["hopper", "reference"])
@pytest.mark.parametrize("name", ["hotspot2d-batched-aux",
                                  "hotspot2d-shared-aux",
                                  "hotspot3d-batched-aux", "chain",
                                  "wave-periodic", "diffusion2d-bf16"])
def test_run_batch_equals_sequential_runs(name, backend):
    """Members of a batch are independent: ``run_batch`` equals a loop of
    ``run`` bit for bit, on both backends."""
    build, dims, bc, dtype, par_time, bsize, aux_mode, iters = CASES[name]
    mine, _ = _problems(build, dims, bc, dtype)
    g, aux = _batch(mine, seed=3, aux=aux_mode or "batched")
    (tg, _), (ta, _) = _as(g, dtype), _as(aux, dtype)
    p = (_hopper(mine, par_time, bsize) if backend == "hopper" else
         plan(mine, RunConfig(backend="reference", device="cpu")))
    got = p.run_batch(tg, iters, aux=ta)
    for b in range(B):
        a = None if ta is None else (ta[b] if aux_mode == "batched" else ta)
        assert torch.equal(got[b], p.run(tg[b], iters, aux=a)), b


#: id -> (build, dims, boundary, par_time, bsize, the kernel body)
BODIES = {
    "main-path": (_single("hotspot2d"), DIMS2, "clamp", 2, 16, 1),
    "chain": (_chain, (24, 32), "clamp", 2, 16, builder.CHAIN_BODY),
    "dag": (_wave, (22, 19), "periodic", 2, 8, builder.DAG_BODY),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_batched_superstep_equals_single_supersteps(name):
    """One ``superstep_dag`` over ``(B, *state)`` (per-member aux for
    Hotspot, a state of two fields for the wave) equals ``B`` single
    super-steps bit for bit, with and without forwarding."""
    build, dims, bc, par_time, bsize, body = BODIES[name]
    mine, _ = _problems(build, dims, bc)
    p = _hopper(mine, par_time, bsize)
    geom, dag, bc0 = p.geometry, mine.exec_dag, mine.structural_bc
    stages = builder._as_chain(dag)
    assert (builder.kernel_body(stages) if stages else builder.DAG_BODY) \
        == body
    g, aux = _batch(mine, seed=5)
    gp = ops._pad_blocked(torch.from_numpy(g), geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(torch.from_numpy(aux),
                                                      geom, bc0)
    c = ops.pack_dag_coeffs(dag, mine.resolve_coeffs())
    for steps in (par_time, par_time - 1):
        out = torch.full_like(gp, float("nan"))
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out)
        for b in range(B):
            single = torch.full_like(gp[b], float("nan"))
            builder.superstep_dag(dag, geom, gp[b].contiguous(), c, steps,
                                  None if aux_p is None else
                                  aux_p[b].contiguous(), out=single)
            assert torch.equal(out[b].nan_to_num(-1.0),
                               single.nan_to_num(-1.0)), (steps, b)


def test_run_batch_refusals():
    """Trailing shape, the aux modes and the batch cap are refused with
    ``repro``'s messages, before anything runs."""
    mine, _ = _problems(_single("hotspot2d"), DIMS2)
    p = _hopper(mine)
    g, aux = _batch(mine)
    with pytest.raises(ValueError, match=r"\(B, \*"):
        p.run_batch(g[0], 2, aux=aux)                  # missing batch axis
    with pytest.raises(ValueError, match=r"\(B, \*"):
        p.run_batch(g[:, :-1], 2, aux=aux)             # wrong grid shape
    with pytest.raises(ValueError, match="at least 1 grid"):
        p.run_batch(g[:0], 2, aux=aux)
    with pytest.raises(ValueError, match="needs an aux"):
        p.run_batch(g, 2)
    with pytest.raises(ValueError, match=r"\(shared\) or .*\(per-batch\)"):
        p.run_batch(g, 2, aux=aux[:2])                 # aux batch of 2 for 3
    with pytest.raises(ValueError, match="iters"):
        p.run_batch(g, -1, aux=aux)
    d = _hopper(_problems(_single("diffusion2d"), DIMS2)[0])
    with pytest.raises(ValueError, match="takes no aux"):
        d.run_batch(g, 2, aux=aux)
    # the gridDim.z cap: a 65536-member batch (a broadcast view: nothing is
    # allocated) is refused by name before it is padded
    many = torch.zeros((1,) + DIMS2).expand((_build.MAX_BATCH + 1,) + DIMS2)
    with pytest.raises(ValueError, match="gridDim.z"):
        d.run_batch(many, 2)
    geom = d.geometry
    dag = d.problem.exec_dag
    c = ops.pack_dag_coeffs(dag, d.problem.resolve_coeffs())
    gp = ops._pad_blocked(torch.zeros(DIMS2), geom)
    with pytest.raises(ValueError, match="gridDim.z"):
        builder.superstep_dag(dag, geom, gp.expand(
            (_build.MAX_BATCH + 1,) + tuple(gp.shape)), c, 1)
    with pytest.raises(ValueError, match="one per member"):
        hp = _hopper(mine).geometry
        hdag = mine.exec_dag
        hc = ops.pack_dag_coeffs(hdag, mine.resolve_coeffs())
        hgp = ops._pad_blocked(torch.from_numpy(g), hp)
        builder.superstep_dag(hdag, hp, hgp, hc, 1,
                              torch.zeros((2,) + tuple(hgp.shape[1:])))


def test_run_batch_iters_zero_and_unbatched_backend():
    """``iters=0`` returns the batch; a backend that registers a bare
    ``execute`` serves ``run_batch`` through a loop of it."""
    mine, _ = _problems(_single("hotspot2d"), DIMS2)
    g, aux = _batch(mine)
    p = _hopper(mine)
    assert torch.equal(p.run_batch(g, 0, aux=aux), torch.from_numpy(g))
    calls = []

    def factory(problem, config, geom):
        def execute(grid, coeffs, iters, aux=None):
            calls.append(int(iters))
            return oracle_run(problem.stencil, grid, coeffs, iters, aux)
        return execute

    register_backend("test_unbatched_batch", factory)
    try:
        q = plan(mine, RunConfig(backend="test_unbatched_batch",
                                 device="cpu"))
        got = q.run_batch(g, 3, aux=aux)
        assert calls == [3] * B
        ref = plan(mine, RunConfig(backend="reference", device="cpu"))
        assert torch.equal(got, ref.run_batch(g, 3, aux=aux))
    finally:
        _REGISTRY.pop("test_unbatched_batch")


def test_prewarm_keys_and_validation():
    mine, _ = _problems(_single("hotspot2d"), DIMS2)
    p = _hopper(mine)
    t = p.prewarm(batch_sizes=(4, 1, 2))
    assert list(t) == ["single", 1, 2, 4] and all(v > 0 for v in t.values())
    assert list(p.prewarm((2,), single=False)) == [2]
    with pytest.raises(ValueError, match="batch sizes"):
        p.prewarm(batch_sizes=(0,))
    with pytest.raises(ValueError, match="iters"):
        p.prewarm(iters=0)


@pytest.mark.parametrize("backend", ["hopper", "reference"])
def test_checkpointed_run_equals_run(backend, tmp_path):
    """``run(checkpoint_every=, checkpoint_dir=)`` equals ``run`` bit for
    bit, on a chunk length that is not a super-step multiple (it is
    rounded up), and on a rerun that finds the directory final."""
    mine, _ = _problems(_single("hotspot2d"), DIMS2)
    p = (_hopper(mine) if backend == "hopper" else
         plan(mine, RunConfig(backend="reference", device="cpu")))
    g, aux = _batch(mine)
    want = p.run(g[0], 9, aux=aux[0])
    ck = str(tmp_path / "ck")
    got = p.run(g[0], 9, aux=aux[0], checkpoint_every=3, checkpoint_dir=ck)
    assert torch.equal(got, want)
    again = p.run(g[0], 9, aux=aux[0], checkpoint_every=3, checkpoint_dir=ck)
    assert torch.equal(again, want)
    with pytest.raises(ValueError, match="go together"):
        p.run(g[0], 9, aux=aux[0], checkpoint_every=3)
