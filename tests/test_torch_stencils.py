"""The port's stencils, boundary conditions, precision policy and oracle
against the reference package, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro.core import boundary as jboundary
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro.kernels import ref as jref
from repro_torch.core import boundary, precision, stencils
from repro_torch.kernels import ref

NAMES = ["diffusion2d", "hotspot2d", "diffusion3d", "hotspot3d"]
BCS = ["clamp", "periodic", "reflect", "constant:0.75"]
DIMS = {2: (13, 17), 3: (6, 7, 9)}


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("name", NAMES)
def test_oracle_matches_reference(name, bc):
    st = stencils.STENCILS[name]
    dims = DIMS[st.ndim]
    g, aux = conf.data(name, dims)
    jc, tc = conf.coeffs(name)
    iters = 3
    want = jref.oracle_run(
        jstencils.STENCILS[name], jnp.asarray(g), jc, iters,
        None if aux is None else jnp.asarray(aux),
        bc=jboundary.BoundaryCondition.make(bc, st.ndim))
    got = ref.oracle_run(
        st, torch.from_numpy(g), tc, iters,
        None if aux is None else torch.from_numpy(aux),
        bc=boundary.BoundaryCondition.make(bc, st.ndim))
    conf.assert_close(got, want, conf.tol(name, iters))


def test_oracle_bf16_matches_reference():
    """bf16 storage, f32 accumulation, one rounding per step."""
    name, iters = "diffusion2d", 4
    g, _ = conf.data(name, DIMS[2])
    jc, tc = conf.coeffs(name)
    gj = jnp.asarray(g, jnp.bfloat16)
    want = jref.oracle_run(jstencils.STENCILS[name], gj, jc, iters)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16()
    got = ref.oracle_run(stencils.STENCILS[name], gt, tc, iters)
    assert got.dtype == torch.bfloat16
    conf.assert_close(got.float(), np.asarray(want.astype(jnp.float32)),
                      conf.tol(name, iters, "bfloat16"))


@pytest.mark.parametrize("kind", ["clamp", "periodic", "reflect",
                                  "constant"])
@pytest.mark.parametrize("n,lo,hi", [(5, 2, 3), (3, 7, 4), (1, 2, 2),
                                     (4, 0, 9)])
def test_pad_axis_bit_exact(kind, n, lo, hi):
    """Including pads wider than the axis, which numpy's modes accept, and
    reflect on a length-1 axis, which degrades to edge replication."""
    x = np.random.default_rng(1).uniform(-1, 1, (3, n, 2)).astype(
        np.float32)
    want = jboundary.pad_axis(jnp.asarray(x), 1, lo, hi, kind, 0.5)
    got = boundary.pad_axis(torch.from_numpy(x), 1, lo, hi, kind, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boundary_spec_parsing_matches_reference():
    for spec in ["clamp", ("clamp", "periodic"), "constant:80",
                 ("reflect", "constant:2.5")]:
        a = boundary.BoundaryCondition.make(spec, 2)
        b = jboundary.BoundaryCondition.make(spec, 2)
        assert (a.kinds, a.value, a.token()) == (b.kinds, b.value, b.token())
    with pytest.raises(ValueError):
        boundary.BoundaryCondition.make(("clamp", "constant:1",
                                         "constant:2"), 3)
    with pytest.raises(ValueError):
        boundary.BoundaryCondition.make("wrap", 2)


def test_stencil_bookkeeping_and_default_coeffs_match_reference():
    for name, st in jstencils.STENCILS.items():
        mine = stencils.STENCILS[name]
        for field in ("ndim", "radius", "flop_pcu", "num_read", "num_write",
                      "has_aux", "coeff_names", "offsets"):
            assert getattr(mine, field) == getattr(st, field), (name, field)
        jc = jstencils.default_coeffs(st)
        tc = stencils.default_coeffs(mine)
        assert list(tc) == list(jc)
        for k in jc:
            assert tc[k].dtype == torch.float32 and tc[k].ndim == 0
            assert tc[k].item() == float(jc[k])
    for mk in ("make_star", "make_box"):
        a = getattr(stencils, mk)(3, 2)
        b = getattr(jstencils, mk)(3, 2)
        assert (a.name, a.offsets, a.coeff_names, a.flop_pcu) == (
            b.name, b.offsets, b.coeff_names, b.flop_pcu)
    a, b = stencils.make_combine(2, 3), jstencils.make_combine(2, 3)
    assert (a.name, a.arity, a.coeff_names) == (b.name, b.arity,
                                                b.coeff_names)


def test_precision_policy_matches_reference():
    for dt in ("float32", "bfloat16", "float64"):
        assert precision.tolerance(dt, 7, 2, 100) == jprecision.tolerance(
            dt, 7, 2, 100)
        assert precision.cell_bytes(dt) == jprecision.cell_bytes(dt)
        assert precision.needs_accum_cast(dt) == \
            jprecision.needs_accum_cast(dt)
    assert precision.normalize_dtype("bf16") == "bfloat16"
    assert precision.normalize_dtype(torch.float32) == "float32"
    assert precision.normalize_dtype(np.float64) == "float64"
    assert precision.accum_dtype("bfloat16") == torch.float32
    with pytest.raises(ValueError):
        precision.normalize_dtype("int32")
