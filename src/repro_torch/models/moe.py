"""Top-k mixture of experts: the router, the plain every-expert route, the
grouped route, and the reference's two expert-parallel routes on a mesh.

:func:`apply_moe` picks the route as the reference's does
(``repro.models.moe.apply_moe``):

  * no sharding rules active (``parallel.use_sharding_rules``), or
    ``n_experts`` not a multiple of the ``experts`` mesh axis:
    :func:`grouped_path`, the reference's one-device function
    (``_dense_path``): every token goes to its ``top_k`` experts, with no
    capacity and no token dropped;
  * rules active and the sequence a multiple of the ``experts`` axis
    (training and prefill, and decode on a mesh whose ``model`` axis is
    1): :func:`ep_a2a_path`, the reference's ``_ep_a2a_path``;
  * otherwise (decode with fewer tokens a sequence than expert shards):
    :func:`ep_bcast_path`, its ``_ep_bcast_path``.

A mesh of one device counts: the launchers always build one, so
``cfg.moe_capacity`` decides which tokens :func:`ep_a2a_path` drops
there too.

The rounding points of the one-device routes are the reference's: the
router's logits, softmax and top-k in f32 (its weight is an f32 leaf
whatever the model's dtype), each expert's products in the model's dtype,
the combine weights rounded to the model's dtype, and each token's sum
over its experts taken in f32 and rounded once.  :func:`dense_path` is
that function step for step: every expert on every token, a ``(T, E, D)``
product; it is the plain version, for the tests and the card's check.
:func:`grouped_path` sorts the (token, expert) pairs by expert and runs
each expert's two matrix products on its own rows only
(``torch.matmul``: the reference has no kernel here, only ``einsum``), at
``top_k / n_experts`` of the dense route's products.  It reads the
per-expert counts on the host once a call.

The mesh routes run the reference's ``shard_map`` bodies one shard at a
time from one process: shard (d, m) of the ``batch`` and ``experts``
axes computes on the mesh's device there, and the ``all_to_all`` is a
slice of each shard's send buffer moved to its peer (a copy between
cards, a view on one).  Each shard runs its ``n_experts / n_ep`` local
experts on its pieces of ``w_in`` and ``w_out`` (a :class:`Sharded` leaf
placed by :func:`moe_axes`, or a whole tensor sliced), gathered over
``wt_fsdp`` (:func:`_fsdp_gather`).  Its capacity buffers have the
reference's fixed shapes, its sorts are stable as ``jnp.argsort`` is
(which tokens are dropped depends on it), and its combine is a
scatter-add in the model's dtype, each token's contributions added in
the order the reference adds them.  The aux loss is the mean of every
shard's own.  Both routes are differentiable under autograd.
:data:`DROP_LOG`, when a list, gets one entry an :func:`ep_a2a_path`
call: its (token, pick) pairs and those the experts ran.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal
from repro_torch.parallel.sharding import (Sharded, as_tensor,
                                           current_rules, device_at,
                                           names_of, unravel)

#: ``None``, or a list that each :func:`ep_a2a_path` call appends
#: ``{"pairs": T·k over every shard, "processed": 0-d tensor}`` to: the
#: pairs the experts ran; the rest were dropped at a capacity
DROP_LOG: Optional[list] = None


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


def moe_axes() -> dict:
    """Logical axes of :func:`init_moe`'s leaves: experts over ``model``,
    the ff dim ZeRO-3 over ``data``."""
    return {"router": (None, None),
            "w_in": ("experts", None, "wt_fsdp"),
            "w_out": ("experts", "wt_fsdp", None)}


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


def _whole(p: dict, device) -> dict:
    return {k: as_tensor(v, device) for k, v in p.items()}


def _fsdp_gather(w, m: int, e_loc: int, device) -> torch.Tensor:
    """Expert shard ``m``'s ``e_loc`` experts of ``w`` on ``device``, every
    ``wt_fsdp`` piece of them gathered (the reference's ``_fsdp_gather``
    of its shard's block): of a :class:`Sharded` leaf the pieces that
    hold them, of a whole tensor a slice (a view on its own device)."""
    rows = slice(m * e_loc, (m + 1) * e_loc)
    if isinstance(w, Sharded):
        return w.region((rows,), device)
    return w[rows].to(device)


def _ep_shards(mesh, rules, B: int):
    """``(n_dp, n_ep, device)`` of the ``batch`` and ``experts`` axes:
    ``device(d, m)`` is the mesh's device at data shard ``d`` (row-major
    over the ``batch`` axes) and expert shard ``m``."""
    dp, ep = names_of(rules["batch"]), names_of(rules["experts"])
    n_dp = math.prod(mesh.shape[a] for a in dp)
    n_ep = math.prod(mesh.shape[a] for a in ep)
    if B % n_dp:
        raise ValueError(f"the MoE's mesh routes split a batch of {B} over "
                         f"{n_dp} data shards")

    def device(d, m):
        return device_at(mesh, {**unravel(mesh, dp, d),
                                **unravel(mesh, ep, m)})
    return n_dp, n_ep, device


def _capacities(T: int, k: int, capacity: float, n_ep: int, e_loc: int):
    """The reference's ``(C_s, C_e)``: a shard's send slots a destination
    (``ceil(T·k·int(8·capacity) / (8·n_ep))``, at least 8, rounded up to
    a multiple of 8) and an expert's slots (``ceil(n_ep·C_s / e_loc)``,
    at least 8)."""
    c_s = max(8, -(-T * k * int(8 * capacity) // (8 * n_ep)))
    c_s = -(-c_s // 8) * 8
    return c_s, max(8, -(-n_ep * c_s // e_loc))


def _scatter_add_in_order(vals, t_s, T: int):
    """``zeros((T, D), vals.dtype).at[t_s].add(vals)`` as the reference's
    scatter runs it: each row's contributions added one by one in the
    order of ``t_s`` (each token appears ``k`` times), in ``vals``'
    dtype."""
    k = vals.shape[0] // T
    c = vals[torch.argsort(t_s, stable=True)].reshape(T, k, -1)
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]
    return out


def ep_a2a_path(x, p, cfg, mesh, rules) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Training and prefill on a mesh (the reference's ``_ep_a2a_path``):
    shard (d, m) takes rows ``d`` of the batch and positions ``m`` of the
    sequence, routes its ``T`` tokens, packs each (token, pick) pair into
    a send buffer of ``C_s`` slots for the expert shard that owns its
    expert (pairs past ``C_s`` are dropped), hands the buffers over
    (the ``all_to_all``), sorts what it received by local expert into
    ``(E_loc, C_e, D)`` (pairs past ``C_e`` dropped), runs its experts'
    two products (``torch.bmm`` over the fixed buffers), and sends the
    rows back, where each token's kept rows are weighted and added in the
    model's dtype.  Returns (out (B, S, D) on ``x``'s device, the mean of
    the shards' aux losses)."""
    B, S, D = x.shape
    E, k, dt = cfg.n_experts, cfg.top_k, x.dtype
    n_dp, n_ep, device = _ep_shards(mesh, rules, B)
    if S % n_ep:
        raise ValueError(f"the all-to-all route splits a sequence of {S} "
                         f"over {n_ep} expert shards")
    e_loc, Bl, Sl = E // n_ep, B // n_dp, S // n_ep
    T = Bl * Sl
    c_s, c_e = _capacities(T, k, cfg.moe_capacity, n_ep, e_loc)
    N = n_ep * c_s
    shards = [(d, m) for d in range(n_dp) for m in range(n_ep)]
    sent, auxes = {}, []
    for d, m in shards:
        dev = device(d, m)
        x2 = x[d * Bl:(d + 1) * Bl, m * Sl:(m + 1) * Sl].to(dev).reshape(
            T, D)
        w, ids, aux = route(x2, as_tensor(p["router"], dev), k)
        auxes.append(aux)
        e_f, w_f = ids.reshape(-1), w.reshape(-1)
        ar = torch.arange(T * k, device=dev)
        dest = e_f // e_loc
        order = torch.argsort(dest * (E + 1) + e_f, stable=True)
        dest_s, e_s, t_s, w_s = (dest[order], e_f[order], (ar // k)[order],
                                 w_f[order])
        seg = torch.searchsorted(dest_s, torch.arange(n_ep, device=dev))
        pos = ar - seg[dest_s]
        keep = pos < c_s
        slot = torch.where(keep, pos, c_s)       # c_s: the dropped slot
        send_x = x2.new_zeros((n_ep, c_s + 1, D)).index_put(
            (dest_s, slot), x2[t_s])[:, :c_s]
        send_e = torch.full((n_ep, c_s + 1), -1, dtype=torch.long,
                            device=dev).index_put((dest_s, slot),
                                                  e_s)[:, :c_s]
        sent[d, m] = (send_x, send_e, dest_s, t_s, w_s, pos, keep)
    back, processed = {}, []
    for d, m in shards:
        dev = device(d, m)
        recv_x = torch.stack([sent[d, j][0][m].to(dev)
                              for j in range(n_ep)]).reshape(N, D)
        recv_e = torch.stack([sent[d, j][1][m].to(dev)
                              for j in range(n_ep)]).reshape(N)
        el = torch.where(recv_e >= 0, recv_e - m * e_loc, e_loc)
        order2 = torch.argsort(el, stable=True)
        el_s = el[order2]
        seg2 = torch.searchsorted(el_s, torch.arange(e_loc, device=dev))
        pos2 = torch.arange(N, device=dev) - seg2[el_s.clamp(0, e_loc - 1)]
        keep2 = (el_s < e_loc) & (pos2 < c_e)
        buf = recv_x.new_zeros((e_loc + 1, c_e + 1, D)).index_put(
            (torch.where(keep2, el_s, e_loc), torch.where(keep2, pos2, c_e)),
            recv_x[order2])[:e_loc, :c_e]
        h = _act(torch.bmm(buf, _fsdp_gather(p["w_in"], m, e_loc, dev)),
                 cfg.act, dt)
        yb = torch.bmm(h, _fsdp_gather(p["w_out"], m, e_loc, dev))
        y_r = yb[el_s.clamp(0, e_loc - 1), pos2.clamp(0, c_e - 1)] \
            * keep2[:, None].to(dt)
        back[d, m] = y_r.new_zeros((N, D)).index_put((order2,), y_r) \
            .reshape(n_ep, c_s, D)
        processed.append(keep2.sum())
    rows = []
    for d in range(n_dp):
        cols = []
        for m in range(n_ep):
            dev = device(d, m)
            _, _, dest_s, t_s, w_s, pos, keep = sent[d, m]
            y_send = torch.stack([back[d, j][m].to(dev)
                                  for j in range(n_ep)])
            got = y_send[dest_s, pos.clamp(0, c_s - 1)] * keep[:, None].to(dt)
            out = _scatter_add_in_order(got * w_s[:, None].to(dt), t_s, T)
            cols.append(out.reshape(Bl, Sl, D).to(x.device))
        rows.append(torch.cat(cols, dim=1))
    if DROP_LOG is not None:
        DROP_LOG.append({"pairs": len(shards) * T * k,
                         "processed": sum(c.to(x.device) for c in processed)})
    aux = torch.stack([a.to(x.device) for a in auxes]).mean()
    return torch.cat(rows, dim=0), aux


def ep_bcast_path(x, p, cfg, mesh, rules) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Decode on a mesh (the reference's ``_ep_bcast_path``): shard (d, m)
    routes all of data shard ``d``'s tokens, runs its ``E_loc`` local
    experts on every token, each masked by the token's routing weight for
    it (0 for an expert it did not pick), and the expert shards' outputs
    are summed in the model's dtype (the ``psum``).  Returns (out (B, S,
    D) on ``x``'s device, the mean of the shards' aux losses)."""
    B, S, D = x.shape
    E, k, dt = cfg.n_experts, cfg.top_k, x.dtype
    n_dp, n_ep, device = _ep_shards(mesh, rules, B)
    e_loc, Bl = E // n_ep, B // n_dp
    rows, auxes = [], []
    for d in range(n_dp):
        out = None
        for m in range(n_ep):
            dev = device(d, m)
            x2 = x[d * Bl:(d + 1) * Bl].to(dev).reshape(Bl * S, D)
            w, ids, aux = route(x2, as_tensor(p["router"], dev), k)
            auxes.append(aux)
            local = torch.arange(m * e_loc, (m + 1) * e_loc, device=dev)
            onehot = (ids[..., None] == local).float()      # (T, k, E_loc)
            comb = torch.einsum("tk,tke->te", w, onehot).to(dt)
            h = torch.einsum("td,edf->tef", x2,
                             _fsdp_gather(p["w_in"], m, e_loc, dev))
            h = _act(h, cfg.act, dt)
            y = torch.einsum("tef,efd->ted", h,
                             _fsdp_gather(p["w_out"], m, e_loc, dev))
            part = torch.einsum("ted,te->td", y, comb).to(x.device)
            out = part if out is None else out + part
        rows.append(out.reshape(Bl, S, D))
    aux = torch.stack([a.to(x.device) for a in auxes]).mean()
    return torch.cat(rows, dim=0), aux


def apply_moe(x, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss f32 0-d), by the route the
    reference's ``apply_moe`` takes for the active rules (the module's
    docstring)."""
    mesh, rules = current_rules()
    if mesh is None or rules is None or rules.get("experts") is None:
        return grouped_path(x, _whole(p, x.device), cfg)
    n_ep = math.prod(mesh.shape[a] for a in names_of(rules["experts"]))
    if cfg.n_experts % n_ep:
        return grouped_path(x, _whole(p, x.device), cfg)
    S = x.shape[1]
    if S % n_ep == 0 and S >= n_ep:
        return ep_a2a_path(x, p, cfg, mesh, rules)
    return ep_bcast_path(x, p, cfg, mesh, rules)
