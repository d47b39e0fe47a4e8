"""Flash attention: the Hopper kernels' wrappers (forward, and the backward's
dQ and dK/dV), their plain versions, the launch counters, the bounds that
hold each kernel against its plain version, and the kernels' byte and FLOP
counts.

:func:`flash_attention` and :func:`flash_attention_lse` take q ``(B, Sq, H,
D)`` and k, v ``(B, Skv, Hkv, D)`` in the model's layout.  For CUDA tensors
they launch ``csrc/flash_fwd.cu`` in one of the forms of :data:`FORMS`
(bf16 at head dims 64, 112 and 128; f32 at 8, 12, 16, 64, 112 and 128);
for CPU tensors they run :func:`flash_fwd_plain`.  Under autograd they go
through a ``torch.autograd.Function`` whose backward, :func:`flash_bwd`,
launches the two kernels of ``csrc/flash_bwd.cu`` for CUDA tensors and
runs :func:`flash_bwd_plain` for CPU tensors.  Nothing falls back: a CUDA
tensor goes to the kernels or raises, and a (dtype, head dim) outside
:data:`FORMS` raises naming ROADMAP B2-rest.
"""
from __future__ import annotations

import math
import threading

import torch

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512
#: unit roundoff of f32, which the f32 bounds are stated in
U_F32 = 2.0 ** -24

#: the kernels' forms, dtype -> head dims, built into ``flash_fwd.cu`` and
#: ``flash_bwd.cu`` (their ``has_form``): bf16 through wgmma from TMA rings
#: (the forward, dQ and dK/dV alike), f32 through FMAs on the CUDA cores
FORMS = {torch.bfloat16: (64, 112, 128),
         torch.float32: (8, 12, 16, 64, 112, 128)}
#: the kernels' code for each dtype (``FlashParams::dtype``)
DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches made by :func:`flash_attention_lse` (CUDA tensors only)
LAUNCHES = 0
#: launches of the backward's dQ and dK/dV kernels (CUDA tensors only)
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
#: the same launches by form: ``("fwd" | "dq" | "dkv", dtype name, D)`` ->
#: count
FORM_LAUNCHES: dict = {}


#: the counter each kernel bumps; under a lock, as autograd runs the
#: backward of each device on a thread of its own
_TOTALS = {"fwd": "LAUNCHES", "dq": "DQ_LAUNCHES", "dkv": "DKV_LAUNCHES"}
_COUNT_LOCK = threading.Lock()


def _count(kernel: str, dtype, D: int) -> None:
    key = (kernel, str(dtype).removeprefix("torch."), D)
    with _COUNT_LOCK:
        globals()[_TOTALS[kernel]] += 1
        FORM_LAUNCHES[key] = FORM_LAUNCHES.get(key, 0) + 1


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


def _fwd_f32_error(q, k, v, causal: bool, tile: int = 256):
    """``(o, lse, err)``: :func:`flash_fwd_plain`'s o and lse of f32 q, k,
    v, and :func:`check_against_plain`'s bound on one f32 computation's
    error in o, before its doubling (see there)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    u = U_F32
    kf, vf = k.float(), v.float()
    ka, va = kf.abs(), vf.abs()
    kpos = torch.arange(Skv, device=q.device)
    o, lse = flash_fwd_plain(q, k, v, causal, tile)
    err = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, tile):
        qt = q[:, q0:q0 + tile].float() * (D ** -0.5)
        n = qt.shape[1]
        qg = qt.reshape(B, n, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
        s_abs = torch.einsum("bqhgd,bkhd->bhgqk", qg.abs(), ka)
        if causal:
            qpos = torch.arange(q0, q0 + n, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        w = torch.exp(s - m)
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # p_j / l
        # the relative error of each weight: its score's (D products and
        # q's scaling), s - m's and exp's
        we = w * (u * ((D + 1) * s_abs + (s - m).abs() + 2))
        ot = o[:, q0:q0 + n].float().abs().reshape(B, n, Hkv, G, D)
        ot = ot.permute(0, 2, 3, 1, 4)                           # bhgqd
        e = (torch.einsum("bhgqk,bkhd->bhgqd", we, va)
             + we.sum(-1, keepdim=True) * ot
             + Skv * u * (torch.einsum("bhgqk,bkhd->bhgqd", w, va) + ot)
             + u * ot)
        err[:, q0:q0 + n] = e.permute(0, 3, 1, 2, 4).reshape(B, n, H, D)
    return o, lse, err


def check_against_plain(o, q, k, v, causal: bool = True, lse=None) -> dict:
    """Hold ``o`` (and f32 ``lse``, when given) computed from bf16 or f32
    q, k, v against :func:`flash_fwd_plain`; raise ``AssertionError``
    past the bounds, else return the readings.

    bf16: the kernel rounds each softmax weight to bf16 before P.V, which
    moves each term ``p_j v_j`` by at most 2**-9 of itself, and both sides
    round o to bf16, one ulp (at most 2**-7 of |o|) apart.  So each element
    of o may differ by ``2**-8 * sum_j p_j |v_j| + 2**-7 * |o| + 1e-5`` (the
    rounding term doubled for margin).  That bound is loose on the late
    rows of diffuse attention, where |o| is small and the roundings cancel
    out, so each row of o (over D) must also lie within 2**-7 of its norm:
    a stale V tile or a wrong KV head there moves a row by far more.  lse
    is f32 on both sides and may differ by 1e-3.

    f32: both sides compute in f32, in other orders, so each lies within E
    of the exact o and the two within 2E; the bound is 2E doubled for
    margin.  With u = 2**-24, o = sum_j w_j v_j (w_j = p_j / l):
    each score is a D-term dot product of q scaled by D**-0.5, off by at
    most (D + 1) u s_abs_j (s_abs_j = D**-0.5 sum_d |q_d k_jd|); s_j - m
    and exp add u |s_j - m| + 2u, so w_j is off by a relative e_j =
    u ((D + 1) s_abs_j + |s_j - m| + 2), which moves o by at most sum_j
    w_j e_j (|v_j| + |o|); the sums over the Skv keys of P V and of l add
    Skv u (sum_j w_j |v_j| + |o|), the division u |o|.  Each element of o
    must lie within 4E; lse within 1e-5.  Faults (a stale V tile, a wrong
    KV head) move o by many times that."""
    dtype = q.dtype
    if dtype == torch.bfloat16:
        want_o, want_lse = flash_fwd_plain(q, k, v, causal)
    elif dtype == torch.float32:
        want_o, want_lse, err = _fwd_f32_error(q, k, v, causal)
    else:
        raise ValueError(f"no kernel bound for {dtype}")
    got, want = o.float(), want_o.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("o holds values that are not finite "
                             "(unwritten or overflowed)")
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        pv_abs = flash_fwd_plain(q, k, v.abs(), causal)[0].float()
        bound = 2 ** -8 * pv_abs + 2 ** -7 * want.abs() + 1e-5
        row_tol, lse_tol = 2 ** -7, 1e-3
    else:
        bound = 4 * err + 1e-30
        row_tol, lse_tol = float("inf"), 1e-5
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    out = {"max_abs_err": diff.max().item(),
           "bound_ratio": (diff / bound).max().item(),
           "row_rel_err": row.max().item(),
           "late_rows_max_abs_err": diff[:, q.shape[1] // 2:].max().item()}
    if lse is not None:
        if not bool(lse.isfinite().all()):
            raise AssertionError("lse holds values that are not finite")
        out["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
    if (out["bound_ratio"] > 1 or out["row_rel_err"] > row_tol
            or out.get("lse_max_abs_err", 0.0) > lse_tol):
        raise AssertionError(f"o or lse differs from the plain version "
                             f"beyond its bound: {out}")
    return out


def _bwd_plain(q, k, v, o, lse, do, causal: bool, tile: int,
               magnitudes: bool):
    """The backward in tiled f32 torch ops; with ``magnitudes``, also the
    sums :func:`check_bwd_against_plain` builds its bounds from (for f32
    inputs, the error bound of one f32 computation of each gradient)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Skv, device=dev)
    delta = (do.float() * o.float()).sum(-1)                    # (B, Sq, H)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    f32 = magnitudes and q.dtype == torch.float32
    if f32:
        u = U_F32
        mag = {"dq_err": torch.empty(q.shape, device=dev),
               "dk_err": torch.zeros(k.shape, device=dev),
               "dv_err": torch.zeros(k.shape, device=dev)}
        kabs, vabs = kf.abs(), vf.abs()
        dlt_abs = (do.float() * o.float()).abs().sum(-1)        # (B, Sq, H)
    elif magnitudes:
        mag = {"dq_abs": torch.empty(q.shape, device=dev),
               "dq_sq": torch.empty((B, Sq, H), device=dev),
               "dk_abs": torch.zeros(k.shape, device=dev),
               "dk_sq": torch.zeros((B, Skv, Hkv), device=dev),
               "dv_abs": torch.zeros(k.shape, device=dev),
               "dv_sq": torch.zeros((B, Skv, Hkv), device=dev)}
        kabs, ksq, vabs = kf.abs(), kf.square().sum(-1), vf.abs()
        dlt_abs = (do.float() * o.float()).abs().sum(-1)        # (B, Sq, H)
    for q0 in range(0, Sq, tile):
        n = min(tile, Sq - q0)
        qt = q[:, q0:q0 + n].float().reshape(B, n, Hkv, G, D)
        dot = do[:, q0:q0 + n].float().reshape(B, n, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kf) * scale
        if causal:
            qpos = torch.arange(q0, q0 + n, device=dev)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        p = torch.exp(s - lse[:, :, q0:q0 + n].reshape(B, Hkv, G, n, 1))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dot, vf)
        dlt = delta[:, q0:q0 + n].reshape(B, n, Hkv, G).permute(0, 2, 3, 1)
        ds = p * (dp - dlt[..., None])
        dq[:, q0:q0 + n] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
                            * scale).reshape(B, n, H, D).to(q.dtype)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qt) * scale
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, dot)
        if f32:
            # P's relative error (its score's D products and scaling, s -
            # lse's and exp's), dP's and delta's D products, and the sums
            # over the Skv keys (dQ) and the G * Sq query rows (dK, dV)
            s_abs = torch.einsum("bqhgd,bkhd->bhgqk", qt.abs(), kabs) * scale
            lse_t = lse[:, :, q0:q0 + n].reshape(B, Hkv, G, n, 1)
            e = u * ((D + 1) * s_abs + (s - lse_t).abs() + 2)
            dp_abs = torch.einsum("bqhgd,bkhd->bhgqk", dot.abs(), vabs)
            dlt_t = dlt_abs[:, q0:q0 + n].reshape(B, n, Hkv, G).permute(
                0, 2, 3, 1)[..., None]
            ds_abs = ds.abs()
            ds_err = ds_abs * (e + u) + D * u * p * (dp_abs + dlt_t)
            mag["dq_err"][:, q0:q0 + n] = (
                torch.einsum("bhgqk,bkhd->bqhgd", ds_err + Skv * u * ds_abs,
                             kabs) * scale).reshape(B, n, H, D)
            mag["dk_err"] += torch.einsum(
                "bhgqk,bqhgd->bkhd", ds_err + G * Sq * u * ds_abs,
                qt.abs()) * scale
            mag["dv_err"] += torch.einsum("bhgqk,bqhgd->bkhd",
                                          p * (e + G * Sq * u), dot.abs())
        elif magnitudes:
            # |dS| and the f32 rounding of dP - delta, which cancel where
            # dS is near 0 (2**-8 of the sums of |terms|: many times the
            # worst case of a 128-term f32 dot product)
            dp_abs = torch.einsum("bqhgd,bkhd->bhgqk", dot.abs(), vabs)
            dlt_t = dlt_abs[:, q0:q0 + n].reshape(B, n, Hkv, G).permute(
                0, 2, 3, 1)[..., None]
            ads = ds.abs() + 2 ** -8 * p * (dp_abs + dlt_t)
            ds2 = ads.square()
            mag["dq_abs"][:, q0:q0 + n] = (torch.einsum(
                "bhgqk,bkhd->bqhgd", ads, kabs) * scale).reshape(B, n, H, D)
            mag["dq_sq"][:, q0:q0 + n] = (torch.einsum(
                "bhgqk,bkh->bqhg", ds2, ksq) * scale ** 2).reshape(B, n, H)
            mag["dk_abs"] += torch.einsum("bhgqk,bqhgd->bkhd", ads,
                                          qt.abs()) * scale
            mag["dk_sq"] += torch.einsum("bhgqk,bqhg->bkh", ds2,
                                         qt.square().sum(-1)) * scale ** 2
            mag["dv_abs"] += torch.einsum("bhgqk,bqhgd->bkhd", p, dot.abs())
            mag["dv_sq"] += torch.einsum("bhgqk,bqhg->bkh", p.square(),
                                         dot.square().sum(-1))
    out = (dq, dk.to(k.dtype), dv.to(v.dtype))
    if f32:
        for name, g in zip(("dq", "dk", "dv"), out):
            mag[f"{name}_err"] += u * g.abs()       # the last scaling
    return (out, mag) if magnitudes else out


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                    tile: int = 256):
    """The backward kernels' function in torch ops: ``(dq, dk, dv)`` from
    the forward's ``o`` and f32 ``lse`` and the output gradient ``do``.
    Tiles of ``tile`` query rows against all keys, in f32 throughout, as
    the TPU kernels compute it (P = exp(S - lse) recomputed, delta =
    rowsum(dO * O)); dq is cast to q's dtype, dk and dv, summed over each
    KV head's G query heads, to k's."""
    return _bwd_plain(q, k, v, o, lse, do, causal, tile, magnitudes=False)


def check_bwd_against_plain(grads, q, k, v, o, lse, do,
                            causal: bool = True) -> dict:
    """Hold ``grads = (dq, dk, dv)`` from the backward kernels against
    :func:`flash_bwd_plain` on the same bf16 or f32 inputs; raise
    ``AssertionError`` past the bounds, else return the readings.

    bf16: the kernels round P to bf16 before dV = P^T dO, and dS before
    dQ = dS K and dK = dS^T Q; the plain version keeps both f32.  Rounding
    to bf16 moves a value by at most u = 2**-8 of itself, so each element of dV
    may move by u * sum_i P_ij |dO_i| (likewise dK and dQ with |dS|), and
    both sides round their output to bf16, 2u of it between them.  Where
    dP and delta cancel, dS carries their f32 rounding, so |dS| is widened
    by ``2**-8 * P * (sum_d |dO||V| + sum_d |dO||O|)``.  Each element must
    lie within ``2**-7 * (sum_term + |want|)`` (the first term doubled for
    margin).  That bound is loose where many terms of mixed sign add up,
    as on the late rows of dQ, so each row (over D) must also lie within
    ``2**-6 * sqrt(sum_sq) + 2**-7 * |want_row|``, where
    ``sum_sq = sum_i P_ij**2 |dO_i|**2`` (dS and |Q|, |K| for dK and dQ):
    independent roundings add up to about u/2 * sqrt(sum_sq) over a row,
    and a skipped tile, a wrong KV head or a q-head missing from dK's
    G-sum moves a row by far more.

    f32: the kernels keep P and dS in f32, as the plain version does, and
    sum in other orders; each side lies within E of the exact gradient,
    the two within 2E, and the bound is 2E doubled for margin.  With u =
    2**-24: P_ij = exp(S_ij - lse_i) is off by a relative e_ij = u ((D +
    1) s_abs_ij + |S_ij - lse_i| + 2) (its score's D products and scaling,
    the subtraction, exp); dP and delta are D-term dot products, so dS =
    P (dP - delta) is off by |dS| (e + u) + D u P (sum_d |dO||V| + sum_d
    |dO||O|).  dQ = scale sum_j dS_ij K_j adds the Skv-term sum's Skv u
    sum_j |dS||K| scale; dK and dV sum over the G * Sq query rows of their
    KV head (G * Sq u sum |dS||Q| scale, and P (e + G * Sq u) |dO| for
    dV); the final scaling adds u |grad|.  Each element must lie within 4E
    (the row readings are reported against the norm of that bound)."""
    want, mag = _bwd_plain(q, k, v, o, lse, do, causal, 256,
                           magnitudes=True)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"no kernel bound for {q.dtype}")
    out = {}
    failed = []
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        got, ref = got.float(), ref.float()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{name} holds values that are not finite "
                                 f"(unwritten or overflowed)")
        diff = (got - ref).abs()
        row = diff.norm(dim=-1)
        if q.dtype == torch.float32:
            bound = 4 * mag[f"{name}_err"] + 1e-30
            row_bound = bound.norm(dim=-1)
        else:
            bound = 2 ** -7 * (mag[f"{name}_abs"] + ref.abs()) + 1e-30
            row_bound = (2 ** -6 * mag[f"{name}_sq"].sqrt()
                         + 2 ** -7 * ref.norm(dim=-1) + 1e-30)
        out[f"{name}_max_abs_err"] = diff.max().item()
        out[f"{name}_bound_ratio"] = (diff / bound).max().item()
        out[f"{name}_row_bound_ratio"] = (row / row_bound).max().item()
        out[f"{name}_late_rows_max_abs_err"] = diff[
            :, diff.shape[1] // 2:].max().item()
        if out[f"{name}_bound_ratio"] > 1 or \
                out[f"{name}_row_bound_ratio"] > 1:
            failed.append(name)
    if failed:
        raise AssertionError(f"{', '.join(failed)} differ from the plain "
                             f"version beyond the bound: {out}")
    return out


def _check(q, k, v, block_q: int, block_kv: int) -> None:
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


def require_form(dtype, D: int) -> None:
    """Raise unless the kernels were built for ``(dtype, D)``
    (:data:`FORMS`); needs no card."""
    if D not in FORMS.get(dtype, ()):
        raise ValueError(
            f"the flash kernels have no form for {dtype} at head dim {D}; "
            f"they take " + ", ".join(
                f"{str(t).removeprefix('torch.')} at {list(ds)}"
                for t, ds in FORMS.items()) + " (ROADMAP B2-rest)")


def _require_card(q, k, v) -> None:
    """What every flash kernel takes: q, k and v of one dtype, a (dtype,
    head dim) the kernels were built for (:func:`require_form`), and a
    card."""
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k and v must share a dtype; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    require_form(q.dtype, q.shape[-1])
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA tensor but no CUDA device")


def _layout_ok(t) -> bool:
    """The kernels read 16-byte chunks of the head dim through strides:
    8 bf16 or 4 f32 elements."""
    chunk = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % chunk for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _require_layout(**tensors) -> None:
    for name, t in tensors.items():
        if not _layout_ok(t):
            raise ValueError(f"{name} needs a contiguous head dim, strides "
                             f"that are multiples of {16 // t.element_size()} "
                             f"elements (16 bytes) and a 16-byte aligned "
                             f"start; got strides {t.stride()}")


def _strides(**tensors) -> dict:
    return {f"{name}_s{d}": t.stride(i) for name, t in tensors.items()
            for i, d in enumerate("bsh")}


def _launch(q, k, v, causal: bool, out=None):
    from repro_torch.kernels import _build
    _require_card(q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
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
    _require_layout(q=q, k=k, v=v, o=o)
    params = _build.FlashParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr(),
        q_sb=q.stride(0), q_ss=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_ss=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_ss=v.stride(1), v_sh=v.stride(2),
        o_sb=o.stride(0), o_ss=o.stride(1), o_sh=o.stride(2),
        B=B, H=H, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D, causal=int(causal),
        dtype=DTYPE_CODE[q.dtype], scale=D ** -0.5,
        scale_log2=D ** -0.5 * math.log2(math.e))
    dll = _build.flash_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = dll.flash_fwd_launch(params, stream)
    if err != 0:
        msg = dll.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} ({err})")
    _count("fwd", q.dtype, D)
    return o, lse


def _bwd_params(q, k, v, o, lse, do, delta, dq, dk, dv, causal: bool):
    from repro_torch.kernels import _build
    _require_card(q, k, v)
    if not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o and do must be {q.dtype} like q, k and v; got "
                         f"{o.dtype}, {do.dtype}")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)}; "
                         f"got {tuple(o.shape)}, {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 (B, H, Sq)")
    tensors = dict(q=q, k=k, v=v, o=o, do=do, dq=dq, dk=dk, dv=dv)
    if any(t.device != q.device for t in (lse, delta, *tensors.values())):
        raise ValueError("the backward's tensors must be on one device")
    _require_layout(**tensors)
    return _build.FlashBwdParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        dout=do.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(),
        **_strides(**tensors), B=B, H=H, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D,
        causal=int(causal), dtype=DTYPE_CODE[q.dtype], scale=D ** -0.5,
        scale_log2=D ** -0.5 * math.log2(math.e))


def _run_bwd(entry: str, params, device) -> None:
    from repro_torch.kernels import _build
    dll = _build.flash_bwd()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(dll, entry)(params, stream)
    if err != 0:
        msg = dll.flash_bwd_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: {msg} ({err})")


def _outputs(out, likes):
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=dev)
                     for shape, dtype, dev in likes)
    for t, (shape, dtype, dev) in zip(out, likes):
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"out: expected {tuple(shape)} {dtype} on "
                             f"{dev}; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    return tuple(out)


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = True, out=None):
    """Launch the dQ kernel: ``(dq, delta)``, dq like q and ``delta =
    rowsum(dO * O)`` ``(B, H, Sq)`` f32, which :func:`flash_bwd_dkv`
    reads; written into the pair ``out`` when it is given.  CUDA tensors
    only."""
    B, Sq, H, _ = q.shape
    dq, delta = _outputs(out, ((q.shape, q.dtype, q.device),
                               ((B, H, Sq), torch.float32, q.device)))
    # the dK/dV slots are not touched by this kernel
    params = _bwd_params(q, k, v, o, lse, do, delta, dq, k, v, causal)
    _run_bwd("flash_bwd_dq_launch", params, q.device)
    _count("dq", q.dtype, q.shape[-1])
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True, out=None):
    """Launch the dK/dV kernel: ``(dk, dv)`` like k and v, each KV head's
    G query heads summed in the kernel; written into the pair ``out`` when
    it is given.  CUDA tensors only."""
    dk, dv = _outputs(out, ((k.shape, k.dtype, k.device),
                            (v.shape, v.dtype, v.device)))
    # the O and dQ slots are not touched by this kernel
    params = _bwd_params(q, k, v, q, lse, do, delta, q, dk, dv, causal)
    _run_bwd("flash_bwd_dkv_launch", params, q.device)
    _count("dkv", q.dtype, q.shape[-1])
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool = True):
    """``(dq, dk, dv)``: the two backward kernels for CUDA tensors,
    :func:`flash_bwd_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not _layout_ok(do):         # an output gradient has any strides
        do = do.contiguous()
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward (kernel or plain version), saving q, k,
    v, o and lse.  Backward: :func:`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def _forward(q, k, v, causal: bool, out=None):
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


def flash_attention_lse(q, k, v, causal: bool = True,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_kv: int = DEFAULT_BLOCK_KV, out=None):
    """``(o, lse)``: o like q, lse ``(B, H, Sq)`` f32, written into the
    pair ``out`` when it is given.  ``block_q`` and ``block_kv`` only fix
    which shapes are accepted, as in the TPU kernel: Sq and Skv must be
    multiples of them (or shorter); the Hopper kernel tiles by its own
    sizes and masks its ragged edge.  When q, k or v requires a gradient,
    the backward runs :func:`flash_bwd`."""
    _check(q, k, v, block_q, block_kv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if out is not None:
            raise ValueError("out= cannot hold a result that needs a "
                             "gradient")
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, out)


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


def flash_bwd_kernel_flops(B: int, Sq: int, Skv: int, H: int, D: int,
                           causal: bool, kernel: str) -> float:
    """Matrix-unit FLOPs of one backward kernel: both recompute S and dP;
    ``"dq"`` adds dS K (3 products), ``"dkv"`` P^T dO and dS^T Q (4)."""
    products = {"dq": 3, "dkv": 4}[kernel]
    pairs = Sq * Skv * (0.5 if causal else 1.0)
    return products * 2 * B * H * pairs * D


def flash_bwd_kernel_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int,
                           D: int, kernel: str, bytes_el: int = 2) -> int:
    """Device-memory bytes of one backward kernel's function, each input
    read once and each output written once: ``"dq"`` reads Q, K, V, O, dO
    and lse and writes dQ and delta; ``"dkv"`` reads Q, K, V, dO, lse and
    delta and writes dK and dV."""
    qb = B * Sq * H * D * bytes_el
    kvb = B * Skv * Hkv * D * bytes_el
    rows = B * H * Sq * 4
    if kernel == "dq":
        return 4 * qb + 2 * kvb + 2 * rows
    if kernel == "dkv":
        return 2 * qb + 4 * kvb + 2 * rows
    raise ValueError(kernel)
