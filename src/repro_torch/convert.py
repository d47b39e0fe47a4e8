"""Carrying the reference package's parameters and state across.

The "weights" of a stencil run are its scalar coefficients and its input
grids; those of a model are its parameter tree, its decode caches and its
optimizer state.  These functions take them as numpy arrays — the form the
reference package's values take after ``np.asarray`` — and return the
port's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.stencils import Stencil
from repro_torch.models.transformer import ModelConfig, init_params


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


def _tensor(array, dtype, device) -> torch.Tensor:
    # via f32: numpy has no bf16 of its own, and bf16 -> f32 -> bf16 is exact
    return torch.tensor(np.asarray(array, np.float32)).to(
        device=device, dtype=dtype)


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device="cpu") -> dict:
    """The reference's ``init_params`` tree (stacked ``(L, ...)`` leaves, as
    numpy arrays) -> the port's parameters in ``cfg``'s dtype on
    ``device``.  Keys and shapes must be those the port's ``init_params``
    makes for ``cfg``."""
    want = init_params(cfg, torch.Generator().manual_seed(0), "meta")

    def carry(want_node, got_node, path):
        if isinstance(want_node, dict):
            got = (sorted(got_node) if isinstance(got_node, Mapping)
                   else type(got_node).__name__)
            if got != sorted(want_node):
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(want_node)}, got {got}")
            return {k: carry(want_node[k], got_node[k], f"{path}/{k}")
                    for k in want_node}
        shape = tuple(np.shape(got_node))
        if shape != tuple(want_node.shape):
            raise ValueError(f"{path}: expected shape "
                             f"{tuple(want_node.shape)}, got {shape}")
        return _tensor(got_node, cfg.tdtype, device)
    return carry(want, tree, "")


def caches_from_reference(tree: Mapping, device="cpu",
                          dtype=torch.float32) -> dict:
    """The reference's dense decode caches (``{"k", "v"}`` of ``(L, B,
    max_len, n_kv, d_head)`` and the 0-d ``"length"``) -> the port's, with
    ``length`` a Python int."""
    return {"k": _tensor(tree["k"], dtype, device),
            "v": _tensor(tree["v"], dtype, device),
            "length": int(np.asarray(tree["length"]))}


def opt_state_from_reference(cfg: ModelConfig, state, device="cpu"):
    """The reference's ``AdamWState`` (its leaves as numpy arrays; master
    leaves ``None`` for f32 parameters) -> the port's: ``step`` a 0-d int32
    tensor, ``m``, ``v`` and, for parameters that are not f32, ``master``
    as f32 trees shaped like ``params_from_reference``'s."""
    from repro_torch.optim import AdamWState
    f32 = dataclasses.replace(cfg, dtype="float32")
    step, m, v, master = state
    m = params_from_reference(f32, m, device)
    v = params_from_reference(f32, v, device)
    if cfg.tdtype == torch.float32:
        master = _none_like(m)
    else:
        master = params_from_reference(f32, master, device)
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                   device=device), m, v, master)


def _none_like(tree):
    if isinstance(tree, Mapping):
        return {k: _none_like(v) for k, v in tree.items()}
    return None
