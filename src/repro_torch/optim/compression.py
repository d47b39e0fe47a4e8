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
only.  A placed leaf (``parallel.Sharded``) is compressed in its pieces,
where they lie, with the whole leaf's threshold and scale: the k-th
largest magnitude by a radix select whose histograms are added over the
pieces, and the largest kept magnitude over every piece, so the kept
values, the residual (placed like the gradient) and the wire bytes are
those of the whole leaf.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import map_pieces, pieces_of


def init_ef_state(params):
    """f32 zeros shaped like each parameter (placed like it)."""
    if isinstance(params, dict):
        return {k: init_ef_state(v) for k, v in params.items()}
    return map_pieces(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def _kth_largest(parts, k: int) -> torch.Tensor:
    """The k-th largest element of the flat, non-negative f32 tensors
    ``parts`` together (a tensor, or a list of them on any devices), as a
    0-d tensor on the first one's device, by a radix select over their bit
    patterns (for non-negative floats the int32 order is the float order):
    four passes of an 8-bit histogram, added over the parts, of the
    elements whose higher bits match the digits chosen so far.  Exact, as
    ``top_k(concat(parts), k)[0][-1]`` is, without sorting or gathering
    them."""
    if isinstance(parts, torch.Tensor):
        parts = [parts]
    home = parts[0].device
    cands = [a.view(torch.int32) for a in parts]
    prefix = 0
    for shift in (24, 16, 8, 0):
        if shift < 24:
            cands = [c[(c >> (shift + 8)) == (prefix >> (shift + 8))]
                     for c in cands]
        hist = sum(torch.bincount((c >> shift) & 0xFF, minlength=256)
                   .to(home) for c in cands)
        # at_least[i]: the candidates whose digit is 255 - i or more
        at_least = hist.flip(0).cumsum(0)
        i = int(torch.searchsorted(at_least, k))
        if i:
            k -= int(at_least[i - 1])
        prefix |= (255 - i) << shift
    return torch.tensor([prefix], dtype=torch.int32).view(
        torch.float32)[0].to(home)


def _topk_keep(parts: list, keep_ratio: float) -> list:
    """``|x| >= t`` (bool) a part, ``t`` the k-th largest ``|x|`` over
    every element of ``parts`` (the pieces of one leaf), ``k = max(1,
    int(n * keep_ratio))``: ties at ``t`` are all kept, as in the
    reference."""
    k = max(1, int(sum(p.numel() for p in parts) * keep_ratio))
    thresh = _kth_largest([p.abs().reshape(-1) for p in parts], k)
    return [p.abs() >= thresh.to(p.device) for p in parts]


def _topk_mask(x: torch.Tensor, keep_ratio: float) -> torch.Tensor:
    """:func:`_topk_keep` of one whole leaf, in ``x``'s dtype (f32)."""
    return _topk_keep([x], keep_ratio)[0].to(x.dtype)


def _quant_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values of ``x`` at ``scale``; rounds half to even, as
    ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _scale(kept: list, home) -> torch.Tensor:
    """The f32 scale ``max(max|x|, 1e-12) / 127`` over every piece of
    ``kept``, on ``home``, taken as the reference's compiled step takes
    it: times the f32 reciprocal of 127 (XLA's rewrite of a division by a
    constant)."""
    top = torch.stack([x.abs().max().to(home) for x in kept]).max()
    return torch.clamp(top, min=1e-12) * (1.0 / 127.0)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _one(g, e, keep_ratio: float, quantize: bool):
    """One leaf (a tensor, or a :class:`Sharded` in pieces): ``(kept in
    g's dtype, f32 residual, f32 wire bytes)``, both trees' leaves placed
    like ``g``; the reference's ops in its order, some of them in place to
    bound a full-width leaf's temporaries, the mask over the whole leaf
    (:func:`_topk_keep`)."""
    gf = map_pieces(lambda a, b: a.to(torch.float32) + b, g, e)
    parts = pieces_of(gf)
    home = parts[0].device
    keep = _topk_keep(parts, keep_ratio)
    # ``x * mask`` as the reference's compiled step computes it: a select,
    # so a dropped element is +0 whatever its sign
    kept = [torch.where(m, p, 0.0) for m, p in zip(keep, parts)]
    if quantize:
        scale = _scale(kept, home)
        kept = [torch.where(m, _dequant(_quant_int8(x, s), s), 0.0)
                for m, x, s in zip(keep, kept,
                                   (scale.to(p.device) for p in parts))]
    # the count is exact here; the reference sums the f32 mask, exact up
    # to 2**24 kept elements
    n = sum(m.sum(dtype=torch.int64).to(home) for m in keep).to(
        torch.float32)
    del keep
    for p, x in zip(parts, kept):
        p.sub_(x)                       # gf becomes the residual
    wire = n * (1 if quantize else 4) + 4 * torch.ceil(n / 8)
    it = iter(kept)
    out = map_pieces(lambda p: next(it).to(p.dtype), g)
    return out, gf, wire


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
