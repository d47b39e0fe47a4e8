"""Error-feedback gradient compression, in the reference's arithmetic
(``optim/compression.py`` of the JAX package).

EF21-style: each leaf of ``grads + residual`` keeps its top-k magnitudes
(a ``keep_ratio`` share of its elements, ties at the threshold kept too),
optionally quantized to int8 with one scale a leaf; what is dropped is
fed back into the next step as the residual.  The compressed values are
what would cross the slow cross-pod link; on one card the step applies
them as they are.

The leaves are taken one at a time, in the reference's (sorted-key)
order, so a full-width leaf's f32 temporaries are alive for that leaf
only.
"""
from __future__ import annotations

from typing import Tuple

import torch


def init_ef_state(params):
    """f32 zeros shaped like each parameter."""
    if isinstance(params, dict):
        return {k: init_ef_state(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def _kth_largest(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest element of the flat, non-negative f32 ``a``, as a
    0-d tensor on its device, by a radix select over its bit patterns
    (for non-negative floats the int32 order is the float order): four
    passes of an 8-bit histogram over the elements whose higher bits
    match the digits chosen so far.  Exact, as ``top_k(a, k)[0][-1]`` is,
    without sorting the leaf."""
    cand = a.view(torch.int32)
    prefix = 0
    for shift in (24, 16, 8, 0):
        if shift < 24:
            cand = cand[(cand >> (shift + 8)) == (prefix >> (shift + 8))]
        hist = torch.bincount((cand >> shift) & 0xFF, minlength=256)
        # at_least[i]: the candidates whose digit is 255 - i or more
        at_least = hist.flip(0).cumsum(0)
        i = int(torch.searchsorted(at_least, k))
        if i:
            k -= int(at_least[i - 1])
        prefix |= (255 - i) << shift
    return torch.tensor([prefix], dtype=torch.int32).view(
        torch.float32)[0].to(a.device)


def _topk_mask(x: torch.Tensor, keep_ratio: float) -> torch.Tensor:
    """``|x| >= t`` in ``x``'s dtype (f32), ``t`` the k-th largest ``|x|``
    of the flattened leaf, ``k = max(1, int(n * keep_ratio))``: ties at
    ``t`` are all kept, as in the reference."""
    mag = x.abs()
    k = max(1, int(mag.numel() * keep_ratio))
    thresh = _kth_largest(mag.reshape(-1), k)
    return (mag >= thresh).to(x.dtype)


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the f32 scale ``max(max|x|, 1e-12) / 127``, taken
    as the reference's compiled step takes it: times the f32 reciprocal of
    127 (XLA's rewrite of a division by a constant); rounds half to even,
    as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _one(g: torch.Tensor, e: torch.Tensor, keep_ratio: float,
         quantize: bool):
    """One leaf: ``(kept in g's dtype, f32 residual, f32 wire bytes)``;
    the reference's ops in its order, some of them in place to bound a
    full-width leaf's temporaries."""
    gf = g.to(torch.float32) + e
    mask = _topk_mask(gf, keep_ratio)
    keep = mask != 0
    # ``x * mask`` as the reference's compiled step computes it: a select,
    # so a dropped element is +0 whatever its sign
    kept = torch.where(keep, gf, 0.0)
    if quantize:
        q, scale = _quant_int8(kept)
        kept = torch.where(keep, _dequant(q, scale), 0.0)
        del q
    del keep
    residual = gf.sub_(kept)
    # the count is exact here; the reference sums the f32 mask, exact up
    # to 2**24 kept elements
    n = mask.sum(dtype=torch.int64).to(torch.float32)
    wire = n * (1 if quantize else 4) + 4 * torch.ceil(n / 8)
    return kept.to(g.dtype), residual, wire


@torch.no_grad()
def ef_compress_update(grads, ef_state, keep_ratio: float = 0.05,
                       quantize: bool = True):
    """Compress ``grads + ef_state`` leaf by leaf; returns ``(the values a
    receiver reconstructs, in each gradient's dtype; the new f32
    residual; the wire-bytes estimate, a 0-d f32 tensor)``, the two trees
    in ``grads``' key order.  The residual is taken before the kept values
    are cast to the gradient's dtype, as in the reference."""
    wires = []

    def walk(g, e):
        if not isinstance(g, dict):
            kept, residual, wire = _one(g, e, keep_ratio, quantize)
            wires.append(wire)
            return kept, residual
        done = {k: walk(g[k], e[k]) for k in sorted(g)}
        return ({k: done[k][0] for k in g}, {k: done[k][1] for k in g})
    comp, new_ef = walk(grads, ef_state)
    return comp, new_ef, sum(wires[1:], wires[0])
