"""The port's geometry, unroll arithmetic, padding helpers and plain
super-step against the reference package (its Pallas kernel in interpret
mode), on the same numpy inputs."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import programs as jprograms
from repro.core import blocking as jblocking
from repro.core import boundary as jboundary
from repro.core import stencils as jstencils
from repro.kernels import builder as jbuilder
from repro.kernels import ops as jops
from repro_torch import programs
from repro_torch.core import blocking, boundary, stencils
from repro_torch.kernels import builder, ops

GEOMS = [  # (dims, rad, par_time, bsize, par_vec)
    ((29, 61), 1, 4, (40,), 1),
    ((33, 70), 1, 2, (16,), 3),
    ((9, 22, 30), 1, 4, (20, 20), 1),
    ((11, 25, 17), 2, 2, (12, 14), 2),
]


def _geoms(dims, rad, par_time, bsize, par_vec):
    return (blocking.BlockGeometry(len(dims), dims, rad, par_time, bsize,
                                   par_vec),
            jblocking.BlockGeometry(len(dims), dims, rad, par_time, bsize,
                                    par_vec))


@pytest.mark.parametrize("case", GEOMS)
def test_geometry_and_traffic_match_reference(case):
    mine, ref = _geoms(*case)
    for prop in ("size_halo", "csize", "bnum", "padded_dims", "num_blocks",
                 "cells_read", "cells_written", "redundancy", "slab_lag",
                 "win_slots", "trav"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.stream_slabs() == ref.stream_slabs()
    assert blocking.superstep_traffic_bytes(mine, 2, 1) == \
        jblocking.superstep_traffic_bytes(ref, 2, 1)
    for name in ("diffusion2d", "hotspot3d"):
        for spec in ("clamp", "periodic"):
            nd = len(case[0])
            bc = boundary.BoundaryCondition.make(spec, nd)
            jbc = jboundary.BoundaryCondition.make(spec, nd)
            assert blocking.stream_extension(mine, bc) == \
                jblocking.stream_extension(ref, jbc)
            assert ops.dma_traffic_bytes(
                stencils.STENCILS[name], mine, 4, bc) == \
                jops.dma_traffic_bytes(jstencils.STENCILS[name], ref, 4, jbc)
    assert blocking.bsize_feasible(1, 4, (8,)) is False
    assert blocking.bsize_feasible(1, 4, (9,)) is True


@pytest.mark.parametrize("par_time", [1, 2, 5])
def test_unroll_and_layout_match_reference(par_time):
    st, jst = stencils.HOTSPOT2D, jstencils.HOTSPOT2D
    plan = programs.unroll_dag(programs.chain_dag(((st, None),)), par_time)
    jplan = jprograms.unroll_dag(jprograms.chain_dag(((jst, None),)),
                                 par_time)
    assert plan.linear and jplan.linear
    assert plan.outputs == jplan.outputs
    assert [(e.inputs, e.iteration, e.coeff_lo, e.fused_select)
            for e in plan.entries] == [
        (e.inputs, e.iteration, e.coeff_lo, e.fused_select)
        for e in jplan.entries]
    for V in (1, 2):
        a = programs.dag_layout(plan, V)
        b = jprograms.dag_layout(jplan, V)
        assert (a.radii, a.lags, a.wins, a.out_lag, a.aux_depth) == (
            b.radii, b.lags, b.wins, b.out_lag, b.aux_depth)
    # the kernel's shared memory is exactly the layout's windows
    geom = blocking.BlockGeometry(2, (8, 64), 1, par_time, (32,))
    lay = programs.dag_layout(plan, 1)
    assert blocking.smem_bytes(geom, True) == sum(lay.wins) * 32 * 4


@pytest.mark.parametrize("spec", ["clamp", "periodic", "reflect",
                                  ("constant:0.25", "clamp", "reflect")])
@pytest.mark.parametrize("case,batch", [(c, (2,) if i % 2 else ())
                                        for i, c in enumerate(GEOMS)])
def test_pad_slice_reclamp_bit_exact(case, batch, spec):
    """Every BC kind, 2D and 3D, par_vec stream padding, and a leading
    batch axis."""
    mine, ref = _geoms(*case)
    nd = mine.ndim
    if isinstance(spec, tuple):
        spec = spec[:nd]
    bc = boundary.BoundaryCondition.make(spec, nd)
    jbc = jboundary.BoundaryCondition.make(spec, nd)
    rng = np.random.default_rng(3)
    g = rng.uniform(0.5, 2.0, batch + mine.dims).astype(np.float32)
    gp = ops._pad_blocked(torch.from_numpy(g), mine, bc)
    jgp = jops._pad_blocked(jnp.asarray(g), ref, jbc)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jgp))
    np.testing.assert_array_equal(
        ops._slice_blocked(gp, mine, bc).numpy(),
        np.asarray(jops._slice_blocked(jgp, ref, jbc)))
    # refresh a padded array whose halos hold arbitrary values
    noisy = rng.uniform(-1, 1, gp.shape).astype(np.float32)
    np.testing.assert_array_equal(
        ops._reclamp_padded(torch.from_numpy(noisy), mine, bc).numpy(),
        np.asarray(jops._reclamp_padded(jnp.asarray(noisy), ref, jbc)))


SUPERSTEP = [  # (name, dims, par_time, bsize): several blocks per axis
    ("diffusion2d", (9, 37), 3, (16,)),
    ("hotspot2d", (7, 45), 2, (12,)),
    ("diffusion3d", (6, 14, 15), 2, (10, 10)),
    ("hotspot3d", (5, 13, 16), 2, (9, 10)),
]


@pytest.mark.parametrize("case", SUPERSTEP, ids=lambda c: c[0])
def test_plain_superstep_matches_pallas_interpret(case):
    """One super-step with ``steps = par_time`` and with PE forwarding
    (``steps < par_time``); compared on the compute region the kernels
    write."""
    name, dims, par_time, bsize = case
    mine, ref = _geoms(dims, 1, par_time, bsize, 1)
    g, aux = conf.data(name, dims)
    jc, tc = conf.coeffs(name)
    st, jst = stencils.STENCILS[name], jstencils.STENCILS[name]
    gp = ops._pad_blocked(torch.from_numpy(g), mine)
    jgp = jops._pad_blocked(jnp.asarray(g), ref)
    aux_p = jaux_p = None
    if aux is not None:
        aux_p = ops._pad_blocked(torch.from_numpy(aux), mine)
        jaux_p = jops._pad_blocked(jnp.asarray(aux), ref)
    h = mine.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * c) for n, c in
                                    zip(mine.bnum, mine.csize))
    for steps in (par_time, par_time - 1):
        want = jbuilder.superstep_chain(
            ((jst, None),), ref, jgp, jops.pack_coeffs(jst, jc),
            jnp.asarray(steps, jnp.int32), jaux_p, interpret=True)
        got = builder.superstep_chain(((st, None),), mine, gp,
                                      ops.pack_coeffs(st, tc), steps, aux_p)
        conf.assert_close(got[region], np.asarray(want)[region],
                          conf.tol(name, steps))


def test_plain_superstep_writes_only_the_compute_region():
    name, dims, par_time, bsize = SUPERSTEP[2]
    geom = blocking.BlockGeometry(3, dims, 1, par_time, bsize)
    g, _ = conf.data(name, dims)
    st = stencils.STENCILS[name]
    gp = ops._pad_blocked(torch.from_numpy(g), geom)
    out = torch.full_like(gp, float("nan"))
    builder.superstep_chain(((st, None),), geom, gp,
                            ops.pack_coeffs(st, stencils.default_coeffs(st)),
                            par_time, None, out=out)
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * c) for n, c in
                                    zip(geom.bnum, geom.csize))
    assert not out[region].isnan().any()
    written = math.prod(out[region].shape)
    assert int((~out.isnan()).sum()) == written


def test_superstep_chain_rejects_bad_inputs():
    geom = blocking.BlockGeometry(2, (8, 40), 1, 2, (16,))
    st = stencils.DIFFUSION2D
    gp = torch.zeros((8,) + geom.padded_dims)
    c = ops.pack_coeffs(st, stencils.default_coeffs(st))
    with pytest.raises(NotImplementedError, match="B1g"):
        builder.superstep_chain(((st, None), (st, None)), geom, gp, c, 2)
    with pytest.raises(ValueError, match="B1c"):
        builder.superstep_chain(
            ((st, boundary.BoundaryCondition.make("periodic", 2)),), geom,
            gp, c, 2)
    with pytest.raises(ValueError, match="shape"):
        builder.superstep_chain(((st, None),), geom, gp[1:], c, 2)
    with pytest.raises(ValueError, match="steps"):
        builder.superstep_chain(((st, None),), geom, gp, c, 3)
    with pytest.raises(ValueError, match="alias"):
        builder.superstep_chain(((st, None),), geom, gp, c, 2, out=gp)
    with pytest.raises(ValueError, match="aux"):
        builder.superstep_chain(((stencils.HOTSPOT2D, None),), geom, gp,
                                torch.zeros(4), 2)
