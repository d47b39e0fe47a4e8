"""Top-k mixture of experts: the router, the plain every-expert route and
the grouped route that serving and training take.

Both routes compute the reference's one-device function
(``repro.models.moe._dense_path``): every token goes to its ``top_k``
experts, with no capacity and no token dropped.  The rounding points are
the reference's: the router's logits, softmax and top-k in f32 (its weight
is an f32 leaf whatever the model's dtype), each expert's products in the
model's dtype, the combine weights rounded to the model's dtype, and each
token's sum over its experts taken in f32 and rounded once.

:func:`dense_path` is that function step for step: every expert on every
token, a ``(T, E, D)`` product.  It is the plain version, for the tests
and the card's check.  :func:`grouped_path` sorts the (token, expert)
pairs by expert and runs each expert's two matrix products on its own rows
only (``torch.matmul``: the reference has no kernel here, only
``einsum``), at ``top_k / n_experts`` of the dense route's products.  It
reads the per-expert counts on the host once a call.

The reference's mesh routes (``moe_axes``, the expert-parallel
``all_to_all`` route with its per-expert capacity, and the broadcast
decode route) are not ported yet (ROADMAP A16i); ``cfg.moe_capacity`` is
carried for them and unused.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal


def init_moe(d_model: int, n_experts: int, d_ff: int, act: str, dtype,
             generator, device) -> dict:
    """``router`` (D, E) f32 whatever ``dtype`` is; ``w_in`` (E, D, 2 ff
    for swiglu, else ff) and ``w_out`` (E, ff, D) in ``dtype``; each
    ``normal * fan_in**-0.5``, drawn in that order."""
    mult = 2 if act == "swiglu" else 1
    return {
        "router": normal((d_model, n_experts), torch.float32,
                         d_model ** -0.5, generator, device),
        "w_in": normal((n_experts, d_model, mult * d_ff), dtype,
                       d_model ** -0.5, generator, device),
        "w_out": normal((n_experts, d_ff, d_model), dtype, d_ff ** -0.5,
                        generator, device),
    }


def _act(h, act: str, dtype):
    """swiglu: ``silu(gate) * up`` of the first and last ``ff`` columns;
    gelu: the tanh approximation; the activation in f32, then ``dtype``."""
    if act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate.float()).to(dtype) * up
    if act == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(dtype)
    raise ValueError(act)


def route(x2d, router, top_k: int):
    """x2d (T, D) -> normalised top-k weights (T, k) f32, expert ids (T, k)
    and the auxiliary loss: the Switch load-balance term ``E · Σ f_e P_e``
    (``f`` the share of the T·k picks each expert got, ``P`` its mean
    probability) plus ``1e-3 ×`` the mean squared logsumexp of the
    logits."""
    logits = x2d.float() @ router
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)      # norm_topk_prob
    E = router.shape[1]
    f = torch.bincount(ids.reshape(-1), minlength=E).float()
    f = f / f.sum().clamp_min(1.0)
    aux = E * (f * probs.mean(dim=0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return w, ids, aux + 1e-3 * z


def dense_path(x, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: every expert on every token, combined by the
    routing weights rounded to the model's dtype."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    w, ids, aux = route(x2, p["router"], cfg.top_k)
    onehot = F.one_hot(ids, cfg.n_experts).float()          # (T, k, E)
    comb = torch.einsum("tk,tke->te", w, onehot).to(x.dtype)
    h = torch.einsum("td,edf->tef", x2, p["w_in"])
    h = _act(h, cfg.act, x.dtype)
    y = torch.einsum("tef,efd->ted", h, p["w_out"])
    out = torch.einsum("ted,te->td", y, comb)
    return out.reshape(B, S, D), aux


def dispatch(x2d, ids, n_experts: int):
    """The T·k (token, expert) pairs sorted by expert (stably: by token
    within an expert): ``order`` (T·k,) indexes the flat pairs, ``rows``
    (T·k, D) are their tokens' rows gathered in that order, ``counts`` the
    rows each expert got (a host list).  The rows are taken from the
    tokens repeated k times by a permutation, so under autograd a token's
    k row gradients are summed by one reduction (in f32, rounded once),
    not added one by one into the token's row."""
    T, k = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts).tolist()
    rows = x2d.unsqueeze(1).expand(T, k, x2d.shape[1]).reshape(T * k, -1)
    return order, rows[order], counts


def _per_expert(rows, counts, w):
    """``rows_e @ w[e]`` for each expert on its own consecutive rows of
    ``rows``, concatenated; an expert with no row runs nothing.  ``w`` is
    split by one ``unbind``, so its gradient is one stacked tensor, not
    one full-size tensor an expert."""
    ws, out, start = w.unbind(0), [], 0
    for e, n in enumerate(counts):
        if n:
            out.append(rows[start:start + n] @ ws[e])
            start += n
    return torch.cat(out)


def expert_products(rows, counts, w_in, w_out, act: str):
    """Each expert's ``act(rows_e @ w_in[e]) @ w_out[e]`` in the rows'
    dtype: the two products an expert, the activation once over all
    rows."""
    h = _act(_per_expert(rows, counts, w_in), act, rows.dtype)
    return _per_expert(h, counts, w_out)


def combine(y, order, w, dtype):
    """Each token's ``Σ_j y_j · w_j`` over its k experts: ``y`` (T·k, D) in
    ``order``'s order is put back in (token, pick) order, the weights are
    rounded to ``dtype``, and each product of two ``dtype`` values (exact
    in f32, and in TF32) is summed in f32 by one batched product and
    rounded once."""
    T, k = w.shape
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    y = y[back].reshape(T, k, -1).float()
    return torch.bmm(w.to(dtype).float().unsqueeze(1), y)[:, 0].to(dtype)


def grouped_path(x, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`dense_path`, each expert on its own
    tokens only: :func:`route`, :func:`dispatch`,
    :func:`expert_products`, :func:`combine`."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    w, ids, aux = route(x2, p["router"], cfg.top_k)
    order, rows, counts = dispatch(x2, ids, cfg.n_experts)
    y = expert_products(rows, counts, p["w_in"], p["w_out"], cfg.act)
    return combine(y, order, w, x.dtype).reshape(B, S, D), aux


def apply_moe(x, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss f32 0-d), through
    :func:`grouped_path` on any device."""
    return grouped_path(x, p, cfg)
