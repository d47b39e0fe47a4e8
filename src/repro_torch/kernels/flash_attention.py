"""Flash-attention forward: the Hopper kernel's wrapper, its plain version,
the launch counter, and the kernel's byte and FLOP counts.

:func:`flash_attention` and :func:`flash_attention_lse` take q ``(B, Sq, H,
D)`` and k, v ``(B, Skv, Hkv, D)`` in the model's layout.  For CUDA tensors
they launch ``csrc/flash_fwd.cu`` (bf16 only); for CPU tensors they run
:func:`flash_fwd_plain`.  Nothing falls back: a CUDA tensor goes to the
kernel or raises.  Only the forward is ported: an input that requires a
gradient raises, since the backward kernels come with training (ROADMAP B3,
B4).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512

#: kernel launches made by :func:`flash_attention_lse` (CUDA tensors only)
LAUNCHES = 0


def ref_attention(q, k, v, *, causal: bool = True):
    """Plain oracle: q (B,Sq,H,D); k,v (B,Skv,Hkv,D), GQA-aware; the whole
    (Sq, Skv) score matrix in f32."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (D ** -0.5)
    if causal:
        Skv = k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return o.to(q.dtype)


def flash_fwd_plain(q, k, v, causal: bool = True, tile: int = 256):
    """The kernel's function in torch ops: ``(o, lse)``.  An f32 softmax over
    ``tile`` query rows at a time against all keys (memory stays bounded at
    long sequences), with the scale applied to q in f32 as the TPU kernel
    does; ``o`` is cast to q's dtype and ``lse`` ``(B, H, Sq)`` stays f32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Skv, device=q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, tile):
        qt = q[:, q0:q0 + tile].float() * (D ** -0.5)
        n = qt.shape[1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt.reshape(B, n, Hkv, G, D), kf)
        if causal:
            qpos = torch.arange(q0, q0 + n, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vf) / l
        o[:, q0:q0 + n] = acc.permute(0, 3, 1, 2, 4).reshape(
            B, n, H, D).to(q.dtype)
        lse[:, :, q0:q0 + n] = (m + torch.log(l)).reshape(B, H, n)
    return o, lse


def check_against_plain(o, q, k, v, causal: bool = True, lse=None) -> dict:
    """Hold a bf16 ``o`` (and f32 ``lse``, when given) computed from q, k,
    v against :func:`flash_fwd_plain`; raise ``AssertionError`` past the
    bounds, else return the readings.

    The kernel rounds each softmax weight to bf16 before P.V, which moves
    each term ``p_j v_j`` by at most 2**-9 of itself, and both sides round
    o to bf16, one ulp (at most 2**-7 of |o|) apart.  So each element of o
    may differ by ``2**-8 * sum_j p_j |v_j| + 2**-7 * |o| + 1e-5`` (the
    rounding term doubled for margin).  That bound is loose on the late
    rows of diffuse attention, where |o| is small and the roundings cancel
    out, so each row of o (over D) must also lie within 2**-7 of its norm:
    a stale V tile or a wrong KV head there moves a row by far more.  lse
    is f32 on both sides and may differ by 1e-3."""
    want_o, want_lse = flash_fwd_plain(q, k, v, causal)
    got, want = o.float(), want_o.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("o holds values that are not finite "
                             "(unwritten or overflowed)")
    diff = (got - want).abs()
    pv_abs = flash_fwd_plain(q, k, v.abs(), causal)[0].float()
    bound = 2 ** -8 * pv_abs + 2 ** -7 * want.abs() + 1e-5
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    out = {"max_abs_err": diff.max().item(),
           "bound_ratio": (diff / bound).max().item(),
           "row_rel_err": row.max().item(),
           "late_rows_max_abs_err": diff[:, q.shape[1] // 2:].max().item()}
    if lse is not None:
        if not bool(lse.isfinite().all()):
            raise AssertionError("lse holds values that are not finite")
        out["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
    if (out["bound_ratio"] > 1 or out["row_rel_err"] > 2 ** -7
            or out.get("lse_max_abs_err", 0.0) > 1e-3):
        raise AssertionError(f"o or lse differs from the plain version "
                             f"beyond its bound: {out}")
    return out


def _check(q, k, v, block_q: int, block_kv: int) -> None:
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only: the backward kernels are not "
            "ported yet (ROADMAP B3, B4)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,Sq,H,D) and k, v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H a multiple of Hkv)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    block_q, block_kv = min(block_q, Sq), min(block_kv, Skv)
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"Sq={Sq} and Skv={Skv} must be multiples of "
                         f"block_q={block_q} and block_kv={block_kv}")


def _launch(q, k, v, causal: bool, out=None):
    global LAUNCHES
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA tensor but no CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the flash kernel takes bf16 on the card; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype} (f32: ROADMAP "
                         f"B2-f32)")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if D != 128:
        raise ValueError(f"the flash kernel takes head dim 128 (every ported "
                         f"config's); got {D} (ROADMAP B2-f32)")
    if out is None:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    else:
        o, lse = out
        if (o.shape != q.shape or o.dtype != q.dtype or o.device != q.device
                or lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError("out must be (o like q, contiguous f32 lse "
                             "(B, H, Sq)) on q's device")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a contiguous head dim, strides "
                             f"that are multiples of 8 elements and a "
                             f"16-byte aligned start; got strides "
                             f"{t.stride()}")
    params = _build.FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr(),
        q_sb=q.stride(0), q_ss=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_ss=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_ss=v.stride(1), v_sh=v.stride(2),
        o_sb=o.stride(0), o_ss=o.stride(1), o_sh=o.stride(2),
        B=B, H=H, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D, causal=int(causal),
        scale_log2=D ** -0.5 * math.log2(math.e))
    dll = _build.flash_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dll.flash_fwd_launch(params, stream)
    if err != 0:
        msg = dll.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({err})")
    LAUNCHES += 1
    return o, lse


def flash_attention_lse(q, k, v, causal: bool = True,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_kv: int = DEFAULT_BLOCK_KV, out=None):
    """``(o, lse)``: o like q, lse ``(B, H, Sq)`` f32, written into the
    pair ``out`` when it is given.  ``block_q`` and ``block_kv`` only fix
    which shapes are accepted, as in the TPU kernel: Sq and Skv must be
    multiples of them (or shorter); the Hopper kernel tiles by its own
    sizes and masks its ragged edge."""
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        o, lse = flash_fwd_plain(q, k, v, causal)
        if out is None:
            return o, lse
        out[0].copy_(o)
        out[1].copy_(lse)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, causal, out)


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_kv: int = DEFAULT_BLOCK_KV):
    """Flash attention forward. q (B,Sq,H,D); k/v (B,Skv,Hkv,D) -> o."""
    return flash_attention_lse(q, k, v, causal, block_q, block_kv)[0]


def flash_traffic_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
                        bytes_el: int = 2, train: bool = True) -> int:
    """Device-memory bytes of the kernel's function with each input read
    once and each output written once: fwd reads Q, K, V and writes O and
    lse; bwd reads Q, K, V, O, dO, lse, delta and writes dQ, dK, dV."""
    qb = B * Sq * H * D * bytes_el
    kvb = 2 * B * Skv * Hkv * D * bytes_el
    ob = qb
    lseb = B * Sq * H * 4
    fwd = qb + kvb + ob + lseb
    if not train:
        return fwd
    bwd = (qb + kvb + ob + qb + lseb + lseb) + (qb + kvb)
    return fwd + bwd


def flash_flops(B: int, Sq: int, Skv: int, H: int, D: int,
                causal: bool = True, train: bool = True) -> float:
    """Matrix-unit FLOPs: 2 products fwd (4·S²·D per head, halved when
    causal), 5 bwd."""
    pairs = Sq * Skv * (0.5 if causal else 1.0)
    fwd = 2 * 2 * B * H * pairs * D
    if not train:
        return fwd
    return fwd + 5 * 2 * B * H * pairs * D
