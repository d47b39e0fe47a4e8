"""GQA attention: prefill through the flash kernel or chunked torch ops,
cross-attention to an encoder's memory, and one-token decode over a KV
cache.

Prefill's causal self-attention goes to ``kernels/flash_attention.py`` when
``cfg.attn_impl == "flash"`` (the Hopper kernel on the card, its plain
version on the CPU) and to :func:`chunked_attention`, an online softmax over
(q chunk, kv chunk) pairs in torch ops, when it is ``"xla"``.  As in the
reference, every other attention goes to :func:`chunked_attention` whatever
``attn_impl`` says: an encoder's bidirectional self-attention and
:func:`cross_attention`.  Training differentiates it by autograd through
its loop.  Decode is plain torch ops: the reference's decode has no kernel
either.  A decode cache placed on a mesh (``parallel.Sharded``, split on
its sequence axis by ``cache_axes``' ``kv_seq``, or on its heads) is read
where it lies: each piece's device computes the partial (max, sum,
weighted V) of the step's query over its positions, and the compute
device combines them (the log-sum-exp combine of flash-decoding, which
the reference's GSPMD derives from the same softmax); the step's K and V
are written into the piece that holds position ``length``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, normal, rms_norm, rope_table
from repro_torch.parallel.sharding import Sharded

NEG_INF = -1e30


def init_attention(d_model: int, n_heads: int, n_kv: int, d_head: int,
                   qk_norm: bool, dtype, generator, device) -> dict:
    def w(shape, fan_in):
        return normal(shape, dtype, fan_in ** -0.5, generator, device)
    p = {"wq": w((d_model, n_heads * d_head), d_model),
         "wk": w((d_model, n_kv * d_head), d_model),
         "wv": w((d_model, n_kv * d_head), d_model),
         "wo": w((n_heads * d_head, d_model), n_heads * d_head)}
    if qk_norm:
        p["q_norm"] = torch.ones((d_head,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((d_head,), dtype=dtype, device=device)
    return p


def attention_axes(qk_norm: bool) -> dict:
    """Logical axes of :func:`init_attention`'s leaves."""
    p = {"wq": ("wt_fsdp", "heads"), "wk": ("wt_fsdp", "kv_heads"),
         "wv": ("wt_fsdp", "kv_heads"), "wo": ("heads", "wt_fsdp")}
    if qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _project_qkv(x, p, cfg, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_table(positions, cfg.d_head, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mask_for(qpos, kpos, causal, skv):
    mask = (kpos < skv)[None, :].expand(qpos.shape[0], -1)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    return mask


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 1024):
    """Online-softmax attention over (q chunk, kv chunk) pairs in torch ops,
    forward only.  q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); K/V are repeated to the
    Hq heads.  Scores and the running sums are f32; P is rounded to V's dtype
    before P·V, as in the reference's ``"xla"`` path."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    pad_q, pad_k = nq * q_chunk - Sq, nk * kv_chunk - Skv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = D ** -0.5
    dev = q.device
    out = torch.empty((B, nq * q_chunk, Hq, D), dtype=q.dtype, device=dev)
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hq, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, q_chunk), device=dev)
        acc = torch.zeros((B, Hq, q_chunk, D), device=dev)
        for kj in range(nk):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc.float()) * scale
            s = torch.where(_mask_for(qpos, kpos, causal, Skv), s, NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m2
        o_c = acc / l.clamp_min(1e-30)[..., None]
        out[:, qi * q_chunk:(qi + 1) * q_chunk] = o_c.transpose(1, 2).to(
            q.dtype)
    return out[:, :Sq]


def self_attention(x, p, cfg, positions, *, causal: bool = True,
                   return_kv: bool = False):
    """Train/prefill self-attention block core (no residual/norm); only the
    causal case can take the flash kernel."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cfg.attn_impl == "flash" and causal:
        out = flash_attention(q, k, v, True, cfg.attn_q_chunk,
                              cfg.attn_kv_chunk)
    else:
        out = chunked_attention(q, k, v, causal=causal,
                                q_chunk=cfg.attn_q_chunk,
                                kv_chunk=cfg.attn_kv_chunk)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(x, memory, p, cfg):
    """Decoder-to-encoder attention core (no residual/norm): q from ``x``
    (B,S,D), K and V projected from ``memory`` (B,S_enc,D); no RoPE and no
    qk-norm on either side."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (memory @ p["wk"]).reshape(B, Sm, cfg.n_kv, cfg.d_head)
    v = (memory @ p["wv"]).reshape(B, Sm, cfg.n_kv, cfg.d_head)
    out = chunked_attention(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk,
                            kv_chunk=cfg.attn_kv_chunk)
    return out.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, Hkv, D)
    v: torch.Tensor
    length: int           # tokens already cached


def decode_attention(x, p, cfg, cache: KVCache):
    """One-token decode: attention over the cache's first ``length``
    positions plus this token's own K/V.

    Returns (out (B,1,d_model), new (k,v) for this position)."""
    B = x.shape[0]
    # made on the device: a tensor from a host list would sync each layer
    pos = torch.full((1,), cache.length, device=x.device)
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k_new = (x @ p["wk"]).reshape(B, 1, cfg.n_kv, cfg.d_head)
    v_new = (x @ p["wv"]).reshape(B, 1, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_table(pos, cfg.d_head, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)

    G = cfg.n_heads // cfg.n_kv
    qg = q.reshape(B, cfg.n_kv, G, cfg.d_head).float()
    scale = cfg.d_head ** -0.5
    if isinstance(cache.k, Sharded):
        o = _split_cache_attention(qg, k_new, v_new, cache, scale)
        o = o.reshape(B, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
        return o @ p["wo"], (k_new, v_new)
    Skv = cache.k.shape[1]
    s_cache = torch.einsum("bhgd,bshd->bhgs", qg, cache.k.float()) * scale
    valid = torch.arange(Skv, device=x.device) < cache.length
    s_cache = torch.where(valid, s_cache, NEG_INF)
    s_new = torch.einsum("bhgd,bshd->bhgs", qg, k_new.float()) * scale
    m = torch.maximum(s_cache.amax(dim=-1), s_new[..., 0])
    p_cache = torch.exp(s_cache - m[..., None])
    p_new = torch.exp(s_new[..., 0] - m)
    denom = p_cache.sum(dim=-1) + p_new
    o = torch.einsum("bhgs,bshd->bhgd", p_cache.to(cache.v.dtype).float(),
                     cache.v.float())
    o = (o + p_new[..., None] * v_new[:, 0, :, None, :].float()) \
        / denom[..., None]
    o = o.reshape(B, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return o @ p["wo"], (k_new, v_new)


def _split_cache_attention(qg, k_new, v_new, cache: KVCache, scale):
    """Decode attention over a placed cache: each piece's partial max
    ``m``, sum ``l`` and weighted V ``o`` of ``qg`` (B, Hkv, G, D) over
    its positions (those at or past ``length`` masked), on the piece's
    device, combined on ``qg``'s with the step's own K/V by rescaling each
    partial to the common max.  Returns o (B, Hkv, G, D) f32."""
    dev = qg.device
    s_new = torch.einsum("bhgd,bshd->bhgs", qg, k_new.float())[..., 0] \
        * scale
    parts = []
    local = cache.k.local
    for coord, kp in cache.k.pieces.items():
        vp = cache.v.pieces[coord]
        b, s, h = (slice(c * n, (c + 1) * n)
                   for c, n in zip(coord[:3], local[:3]))
        qp = qg[b, h].to(kp.device)
        sc = torch.einsum("bhgd,bshd->bhgs", qp, kp.float()) * scale
        valid = torch.arange(s.start, s.stop, device=kp.device) \
            < cache.length
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(dim=-1)
        pc = torch.exp(sc - m[..., None])
        o = torch.einsum("bhgs,bshd->bhgd", pc.to(vp.dtype).float(),
                         vp.float())
        parts.append((b, h, m.to(dev), pc.sum(dim=-1).to(dev), o.to(dev)))
    m = s_new.clone()
    for b, h, mp, _, _ in parts:
        m[b, h] = torch.maximum(m[b, h], mp)
    p_new = torch.exp(s_new - m)
    denom = p_new.clone()
    o = p_new[..., None] * v_new[:, 0, :, None, :].float()
    for b, h, mp, lp, op in parts:
        c = torch.exp(mp - m[b, h])
        denom[b, h] += lp * c
        o[b, h] += op * c[..., None]
    return o / denom[..., None]


def update_cache(cache: KVCache, k_new, v_new) -> KVCache:
    """Write this step's K/V at position ``length``.  Unlike the reference's
    ``dynamic_update_slice``, this writes into ``cache.k`` and ``cache.v``
    in place (into the piece that holds the position, for a placed
    cache); the returned cache shares their storage."""
    if isinstance(cache.k, Sharded):
        cache.k.write((slice(None), cache.length), k_new[:, 0])
        cache.v.write((slice(None), cache.length), v_new[:, 0])
        return KVCache(cache.k, cache.v, cache.length + 1)
    cache.k[:, cache.length] = k_new[:, 0]
    cache.v[:, cache.length] = v_new[:, 0]
    return KVCache(cache.k, cache.v, cache.length + 1)


def init_cache(cfg, batch: int, max_len: int, n_layers: int, dtype,
               device) -> KVCache:
    """Zeroed K and V for ``n_layers`` stacked layers, ``(L, B, max_len,
    Hkv, D)``, with nothing cached yet."""
    shape = (n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)
