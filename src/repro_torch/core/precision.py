"""Mixed-precision policy — storage dtypes, f32 accumulation, ulp tolerances.

Grids are stored in the problem's *storage* dtype; every stage application
computes in the *accumulation* dtype.  For 16-bit floats (bf16) that is f32:
taps are widened on read, the arithmetic runs in f32, and the result rounds
back to storage once per stage application.  32-bit and wider floats
accumulate in their own dtype, so the f32 path inserts no casts at all.

:func:`tolerance` is the explicit ulp budget every comparison against the
reference package uses.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: canonical dtype names the port understands
TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}

#: the accumulation dtype of every sub-32-bit float storage dtype
ACCUM_DTYPE = torch.float32

#: machine epsilon (one ulp at 1.0) per supported storage dtype
MACHINE_EPS = {
    "float32": 2.0 ** -23,
    "bfloat16": 2.0 ** -8,
    "float64": 2.0 ** -52,
}

#: per-(fused-)iteration error budget in ulps of the storage dtype
ULPS_PER_ITER = {
    "float32": 16.0,
    "bfloat16": 4.0,
    "float64": 16.0,
}


def normalize_dtype(spec) -> str:
    """Canonical dtype name for a string (``"bfloat16"``/``"bf16"``), a
    ``torch.dtype`` or a numpy dtype or scalar type."""
    if isinstance(spec, torch.dtype):
        name = str(spec).removeprefix("torch.")
    elif isinstance(spec, str):
        name = "bfloat16" if spec in ("bf16", "half-bfloat") else spec
        if name not in TORCH_DTYPES:
            name = np.dtype(name).name
    else:
        name = np.dtype(spec).name
    if name not in TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {spec!r}; "
                         f"supported: {sorted(TORCH_DTYPES)}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` of any spec :func:`normalize_dtype` accepts."""
    return TORCH_DTYPES[normalize_dtype(dtype)]


def cell_bytes(dtype) -> int:
    """Storage bytes per grid cell (4 for f32, 2 for bf16)."""
    return torch_dtype(dtype).itemsize


def accum_dtype(dtype) -> torch.dtype:
    """The compute dtype of one stage application: f32 for sub-32-bit
    floats, the storage dtype itself otherwise."""
    dt = torch_dtype(dtype)
    if dt.is_floating_point and dt.itemsize < 4:
        return ACCUM_DTYPE
    return dt


def needs_accum_cast(dtype) -> bool:
    """True when storage and accumulation dtypes differ (bf16)."""
    return accum_dtype(dtype) != torch_dtype(dtype)


def promote_getter(get):
    """Wrap a neighbour getter so every tap is widened to f32."""
    def wide(off):
        return get(off).to(ACCUM_DTYPE)
    return wide


def apply_stage(stencil, get_or_gets, coeffs, aux, storage_dtype):
    """One stage application under the storage/accumulation policy.  For
    f32 (and wider) this is exactly ``stencil.apply(...)``; for bf16 the
    taps widen to f32 and the result rounds to bf16 once."""
    if not needs_accum_cast(storage_dtype):
        return stencil.apply(get_or_gets, coeffs, aux)
    if isinstance(get_or_gets, tuple):
        gets = tuple(promote_getter(g) for g in get_or_gets)
    else:
        gets = promote_getter(get_or_gets)
    if aux is not None:
        aux = aux.to(ACCUM_DTYPE)
    return stencil.apply(gets, coeffs, aux).to(torch_dtype(storage_dtype))


def tolerance(dtype, iters: int = 1, stages: int = 1,
              scale: Optional[float] = None) -> dict:
    """``{"rtol": ..., "atol": ...}`` for a ``dtype`` result of ``iters``
    iterations of ``stages`` stage applications each: a budget of
    ``ULPS_PER_ITER[dtype] * iters * stages`` ulps, with the absolute floor
    ``atol = rtol * scale`` (pass ``scale=100`` for Hotspot temperatures
    near 80)."""
    name = normalize_dtype(dtype)
    eps = MACHINE_EPS[name]
    ulps = ULPS_PER_ITER[name] * max(1, int(iters)) * max(1, int(stages))
    rtol = ulps * eps
    return {"rtol": rtol, "atol": rtol * (scale if scale else 1.0)}
