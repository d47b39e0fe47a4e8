"""The port's ``distributed`` backend against the reference's on 4 devices.

Run in a subprocess (``tests/test_torch_distributed.py``) with 4 fake CPU
devices for the reference, so the main pytest process keeps its
one-device view; the port runs the same cases on CPU meshes of the same
shapes.  The same numpy inputs go through both packages, and the port's
result must lie within ``repro_torch.core.precision.tolerance`` of the
reference's and equal its own single-device engine bit for bit.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import stencils as jstencils  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import precision, stencils  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)


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
              S(s, name="b", inputs=("u",), coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


def _chain(S, P, st):
    return [S(st.make_star(2, 2), boundary="reflect"), S("diffusion2d")]


def _named(name):
    return lambda S, P, st: name


#: (label, build, dims, boundary, mesh shape, mesh axes, axis_map,
#: par_time, bsize, iters, dtype, batch)
CASES = [
    ("diffusion2d 2x2", _named("diffusion2d"), (32, 64), "clamp", (2, 2),
     ("data", "model"), (("data",), ("model",)), 2, 24, 5, "float32", None),
    ("hotspot2d joint axes", _named("hotspot2d"), (32, 48),
     ("periodic", "reflect"), (2, 2), ("pod", "data"), (("pod", "data"),
                                                         None),
     2, 16, 4, "float32", None),
    ("diffusion3d 2x2", _named("diffusion3d"), (16, 24, 24),
     ("clamp", "periodic", "reflect"), (2, 2), ("a", "b"),
     (("a",), ("b",), None), 2, (12, 12), 5, "float32", None),
    ("hotspot3d 4", _named("hotspot3d"), (16, 24, 24),
     ("reflect", "constant:1.0", "clamp"), (4,), ("d",), (("d",), None, None),
     2, (8, 8), 5, "float32", None),
    ("chain 4", _chain, (32, 40), "clamp", (4,), ("d",), None, 1, 16, 5,
     "float32", None),
    ("wave2d periodic 4", _wave, (32, 24), "periodic", (4,), ("d",), None, 2,
     12, 5, "float32", None),
    ("diamond 2x2", _diamond, (32, 24), ("clamp", "reflect"), (2, 2),
     ("a", "b"), (("a",), ("b",)), 2, 12, 5, "float32", None),
    ("diffusion2d bf16 4", _named("diffusion2d"), (32, 32), "constant:0.5",
     (4,), ("d",), (None, ("d",)), 2, 16, 5, "bfloat16", None),
    ("hotspot2d batch", _named("hotspot2d"), (16, 32), "periodic", (2, 2),
     ("a", "b"), (("a",), ("b",)), 2, 16, 4, "float32", 3),
]


def check(label, build, dims, bc, mshape, axes, axis_map, par_time, bsize,
          iters, dtype, batch):
    prob = api.StencilProblem(build(api.StencilStage, api.StencilProgram,
                                    stencils), dims, boundary=bc, dtype=dtype)
    jprob = japi.StencilProblem(build(japi.StencilStage, japi.StencilProgram,
                                      jstencils), dims, boundary=bc,
                                dtype=dtype)
    rng = np.random.default_rng(0)
    lead = () if batch is None else (batch,)
    g = rng.uniform(0.5, 2.0, lead + prob.state_shape).astype(np.float32)
    aux = None
    if prob.needs_aux:
        aux = rng.uniform(0.0, 0.1, lead + prob.shape).astype(np.float32)
    n = int(np.prod(mshape))
    mesh = make_mesh(mshape, axes, [torch.device("cpu")] * n)
    p = api.plan(prob, api.RunConfig(backend="distributed", mesh=mesh,
                                     axis_map=axis_map, par_time=par_time,
                                     bsize=bsize, device="cpu"))
    eng = api.plan(prob, api.RunConfig(backend="engine", par_time=par_time,
                                       bsize=bsize, device="cpu"))
    jp = japi.plan(jprob, japi.RunConfig(
        backend="distributed", mesh=jax.make_mesh(mshape, axes),
        axis_map=axis_map, par_time=par_time, bsize=bsize))
    tdt = precision.torch_dtype(dtype)
    tg = torch.from_numpy(g).to(tdt)
    ta = None if aux is None else torch.from_numpy(aux).to(tdt)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    ja = None if aux is None else jnp.asarray(aux, getattr(jnp, dtype))
    if batch is None:
        got, mine = p.run(tg, iters, aux=ta), eng.run(tg, iters, aux=ta)
        want = jp.run(jg, iters, aux=ja)
    else:
        got = p.run_batch(tg, iters, aux=ta)
        mine = eng.run_batch(tg, iters, aux=ta)
        want = jp.run_batch(jg, iters, aux=ja)
    assert torch.equal(got, mine), label
    np.testing.assert_allclose(
        got.double().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64),
        err_msg=label, **precision.tolerance(
            dtype, iters, prob.n_stages,
            scale=100 if prob.needs_aux else None))
    print(f"ok {label}")


if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    for case in CASES:
        check(*case)
    print("ALL OK")
