"""Carrying the reference package's parameters and state across.

The "weights" of a stencil run are its scalar coefficients and its input
grids; those of a model are its parameter tree, its decode caches and its
optimizer state.  These functions take them as numpy arrays — the form the
reference package's values take after ``np.asarray`` — and return the
port's tensors.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.stencils import Stencil
from repro_torch.models.transformer import (ModelConfig, init_params,
                                            param_axes)
from repro_torch.parallel.sharding import shard_tree


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


def _carry(want, got, path: str, dtype_of, device):
    """``got`` (nested mappings of numpy arrays) as tensors shaped like
    ``want`` (the port's tree), each leaf in ``dtype_of(want leaf)``; a
    leaf for which that is ``None`` must be ``None`` in ``got`` too and
    stays ``None``."""
    if isinstance(want, dict):
        keys = (sorted(got) if isinstance(got, Mapping)
                else type(got).__name__)
        if keys != sorted(want):
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(want)}, got {keys}")
        return {k: _carry(want[k], got[k], f"{path}/{k}", dtype_of, device)
                for k in want}
    dtype = dtype_of(want)
    if dtype is None or got is None:
        if dtype is not None or got is not None:
            raise ValueError(f"{path}: expected "
                             f"{'no leaf' if dtype is None else 'a leaf'}, "
                             f"got {'None' if got is None else 'a leaf'}")
        return None
    shape = tuple(np.shape(got))
    if shape != tuple(want.shape):
        raise ValueError(f"{path}: expected shape {tuple(want.shape)}, got "
                         f"{shape}")
    return _tensor(got, dtype, device)


def _want(cfg: ModelConfig) -> dict:
    """The port's parameter tree for ``cfg`` on the meta device."""
    return init_params(cfg, torch.Generator().manual_seed(0), "meta")


def _placed(cfg: ModelConfig, tree, mesh, rules):
    """``tree`` (parameter-shaped) placed on ``mesh`` by ``param_axes``
    (each piece a copy), or as it is without a mesh."""
    if mesh is None:
        return tree
    return shard_tree(tree, param_axes(cfg), mesh, rules, copy=True)


def params_from_reference(cfg: ModelConfig, tree: Mapping,
                          device="cpu", mesh=None, rules=None) -> dict:
    """The reference's ``init_params`` tree (stacked ``(L, ...)`` leaves, as
    numpy arrays) -> the port's parameters on ``device``, each leaf in the
    dtype the port's ``init_params`` gives it for ``cfg`` (``cfg``'s dtype,
    but f32 for an SSM layer's ``A_log``, ``D_skip`` and ``dt_bias`` and a
    MoE layer's ``router``); with ``mesh`` and ``rules``, placed on the
    mesh as the reference's launcher places them (``param_axes``).
    Keys and shapes must be those the port's ``init_params`` makes."""
    return _placed(cfg, _carry(_want(cfg), tree, "", lambda w: w.dtype,
                               device), mesh, rules)


def caches_from_reference(tree: Mapping, device="cpu",
                          dtype=torch.float32) -> dict:
    """The reference's decode caches (the dense and MoE families' ``{"k",
    "v"}`` of ``(L, B, max_len, n_kv, d_head)``; the SSM family's ``conv``
    and ``state``; the hybrid's ``attn_k``, ``attn_v``, ``conv``, ``state``
    and ``tail_conv``, ``tail_state``; each with the 0-d ``"length"``) ->
    the port's in ``dtype``, with ``length`` a Python int."""
    out = {k: _tensor(v, dtype, device) for k, v in tree.items()
           if k != "length"}
    out["length"] = int(np.asarray(tree["length"]))
    return out


def opt_state_from_reference(cfg: ModelConfig, state, device="cpu",
                             mesh=None, rules=None):
    """The reference's ``AdamWState`` (its leaves as numpy arrays; a master
    leaf ``None`` for each f32 parameter) -> the port's: ``step`` a 0-d
    int32 tensor, ``m`` and ``v`` f32 trees shaped like
    ``params_from_reference``'s, and ``master`` f32 for each parameter
    that is not f32 and ``None`` for each that is (an f32 leaf of a bf16
    tree too: an SSM layer's ``A_log``, ``D_skip``, ``dt_bias``, a MoE
    layer's ``router``, which AdamW updates in f32); with ``mesh`` and
    ``rules``, the three trees placed like the parameters (the reference
    launcher's ``_shard_tree`` of each by ``param_axes``)."""
    from repro_torch.optim import AdamWState
    want = _want(cfg)
    step, m, v, master = state

    def f32(_):
        return torch.float32

    def master_dtype(w):
        return None if w.dtype == torch.float32 else torch.float32
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                   device=device),
                      *(_placed(cfg, _carry(want, t, name, dtype, device),
                                mesh, rules)
                        for t, name, dtype in ((m, "m", f32), (v, "v", f32),
                                               (master, "master",
                                                master_dtype))))
