"""Carrying the reference package's parameters and state across.

The "weights" of a stencil run are its scalar coefficients and its input
grids.  These functions take them as numpy arrays — the form the reference
package's values take after ``np.asarray`` — and return the port's tensors.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.stencils import Stencil


def coeffs_from_reference(stencil: Stencil, coeffs: Mapping[str, np.ndarray],
                          device="cpu") -> dict:
    """``{name: array}`` -> ``{name: float32 0-d tensor on device}``, with
    exactly ``stencil.coeff_names`` as keys."""
    if set(coeffs) != set(stencil.coeff_names):
        raise ValueError(f"{stencil.name} takes coefficients "
                         f"{list(stencil.coeff_names)}; got {sorted(coeffs)}")
    return {name: torch.tensor(np.asarray(coeffs[name], np.float32).item(),
                               dtype=torch.float32, device=device)
            for name in stencil.coeff_names}


def state_from_reference(array: np.ndarray, device="cpu") -> torch.Tensor:
    """A grid or aux array -> a contiguous tensor of its dtype on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)
