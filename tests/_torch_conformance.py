"""Shared inputs and tolerances of the ``test_torch_*`` conformance tests:
the same numpy data go through the reference package and the port."""
import numpy as np
import torch

from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro_torch.convert import coeffs_from_reference

torch.set_num_threads(1)


def data(stencil_name, dims, seed=0):
    """Grid ``uniform(0.5, 2)`` and, for Hotspot, aux ``uniform(0, 0.1)``,
    as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.0, dims).astype(np.float32)
    aux = None
    if jstencils.STENCILS[stencil_name].has_aux:
        aux = rng.uniform(0.0, 0.1, dims).astype(np.float32)
    return g, aux


def coeffs(stencil_name):
    """(reference coefficients, the port's coefficients carried across)."""
    from repro_torch.core.stencils import STENCILS
    jc = jstencils.default_coeffs(jstencils.STENCILS[stencil_name])
    return jc, coeffs_from_reference(
        STENCILS[stencil_name], {k: np.asarray(v) for k, v in jc.items()})


def tol(stencil_name, iters, dtype="float32"):
    scale = 100 if stencil_name.startswith("hotspot") else None
    return jprecision.tolerance(dtype, iters, 1, scale=scale)


def assert_close(got, want, t):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **t)
