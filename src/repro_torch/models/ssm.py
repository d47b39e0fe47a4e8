"""Mamba2 / SSD (state-space duality) layer: the chunked scan of training
and prefill, and the one-token recurrence of decode.

The chunked scan is the paper's temporal blocking applied to a linear
recurrence: a chunk of Q time-steps is one quadratic form, and only the
(H, P, N) state crosses from chunk to chunk.  The math and its rounding
points are the reference's (``repro.models.ssm``, the minimal SSD of the
Mamba2 paper): B and C are group-expanded to the flat heads (group g feeds
heads g·rep … (g+1)·rep − 1), scores, decays and states are f32, the
intra-chunk product takes ``M`` rounded to the model's dtype, and the final
state leaves in the model's dtype.  The scan is torch ops: the reference
has no kernel for it, only ``einsum`` and a ``lax.scan`` over chunks, which
here is a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal, rms_norm


def init_ssm(cfg, dtype, generator: torch.Generator, device) -> dict:
    """One layer's parameters: projections ``normal * fan_in**-0.5`` and
    conv taps ``normal * 0.5`` in ``dtype``; ``A_log``, ``D_skip`` and
    ``dt_bias`` f32 whatever ``dtype`` is, as the reference keeps them."""
    D = cfg.d_model
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.d_state
    di = H * P

    def w(shape, scale):
        return normal(shape, dtype, scale, generator, device)

    def f32(value):
        return torch.full((H,), value, dtype=torch.float32, device=device)
    return {
        "w_z": w((D, di), D ** -0.5),
        "w_x": w((D, di), D ** -0.5),
        "w_B": w((D, G * N), D ** -0.5),
        "w_C": w((D, G * N), D ** -0.5),
        "w_dt": w((D, H), D ** -0.5),
        "conv_x": w((cfg.d_conv, di), 0.5),
        "conv_bc": w((cfg.d_conv, 2 * G * N), 0.5),
        "A_log": f32(0.0),
        "D_skip": f32(1.0),
        "dt_bias": f32(-2.0),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "w_out": w((di, D), di ** -0.5),
    }


def ssm_axes() -> dict:
    """Logical axes of :func:`init_ssm`'s leaves."""
    return {"w_z": ("wt_fsdp", "heads"), "w_x": ("wt_fsdp", "heads"),
            "w_B": ("wt_fsdp", None), "w_C": ("wt_fsdp", None),
            "w_dt": ("wt_fsdp", "heads"),
            "conv_x": (None, "heads"), "conv_bc": (None, None),
            "A_log": ("heads",), "D_skip": ("heads",), "dt_bias": ("heads",),
            "norm": ("heads",), "w_out": ("heads", "wt_fsdp")}


def _causal_conv(x, w):
    """Depthwise causal conv as shifted adds (no convolution op), as the
    reference computes it.  x (B,S,C), w (d_conv, C)."""
    dc, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(dc))


def _silu(x):
    return F.silu(x.float()).to(x.dtype)


def check_chunks(S: int, chunk: int) -> None:
    """The scan takes whole chunks: ``S`` a multiple of ``min(chunk, S)``,
    so a sequence shorter than one chunk is always taken."""
    if S % min(chunk, S):
        raise ValueError(f"the SSD scan takes a sequence of whole chunks: "
                         f"S={S} is not a multiple of ssd_chunk={chunk}")


def ssd_scan(xh, Bh, Ch, dt, A, chunk: int, init_state=None):
    """Chunked SSD. xh (B,S,H,P); Bh, Ch (B,S,H,N); dt (B,S,H) f32; A (H,)
    f32; ``init_state`` (B,H,P,N) or ``None`` for zeros.

    Returns (y (B,S,H,P), final state (B,H,P,N)), both in xh's dtype."""
    Bsz, S, H, P = xh.shape
    N = Bh.shape[-1]
    check_chunks(S, chunk)
    Q = min(chunk, S)
    nc = S // Q
    dtype = xh.dtype

    cs = torch.cumsum((dt * A).reshape(Bsz, nc, Q, H), dim=2)  # <= 0 steps
    xc = xh.reshape(Bsz, nc, Q, H, P)
    Bc = Bh.reshape(Bsz, nc, Q, H, N)
    Cc = Ch.reshape(Bsz, nc, Q, H, N)
    dtc = dt.reshape(Bsz, nc, Q, H)

    # --- intra-chunk (quadratic within the temporal block) ------------------
    # the (B, nc, H, Q, Q) f32 tensors are the scan's largest: each name is
    # dropped once used, so serving holds about three of them at a time
    M = torch.einsum("bcihn,bcjhn->bchij", Cc.float(), Bc.float())
    cst = cs.permute(0, 1, 3, 2)                                  # (b,c,h,q)
    M = M * torch.exp(cst[..., :, None] - cst[..., None, :])      # (b,c,h,i,j)
    # above the diagonal exp(cs_i - cs_j) is large; only the mask hides it
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    M = torch.where(mask, M, 0.0)
    M = M * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]             # * dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M.to(dtype), xc)
    del M

    # --- per-chunk states (what crosses the temporal block) -----------------
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                  # (b,c,q,h)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bc.float() * (decay_end * dtc)[..., None],
                          xc.float())
    chunk_decay = torch.exp(cs[:, :, -1, :])                      # (b,c,h)
    carry = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = states[:, c] + chunk_decay[:, c, :, None, None] * carry
    prevs = torch.stack(prevs, dim=1)                             # (b,c,h,p,n)

    # --- inter-chunk contribution -------------------------------------------
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cc.float() * torch.exp(cs)[..., None], prevs)
    y = (y_intra.float() + y_inter).reshape(Bsz, S, H, P)
    return y.to(dtype), carry.to(dtype)


def apply_ssm(x, p, cfg, init_state=None) -> Tuple[torch.Tensor, tuple]:
    """Train/prefill. x (B,S,D) -> (out, (final state, conv tail)).

    The conv tail is the last ``d_conv - 1`` pre-activation conv inputs in
    the decode cache's channel order (x | B | C), left-padded with zeros
    when S < d_conv - 1: the prefill-to-decode hand-off."""
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.d_state
    B_, S, _ = x.shape
    rep = H // G
    z = x @ p["w_z"]
    x_pre = x @ p["w_x"]
    bc_pre = torch.cat([x @ p["w_B"], x @ p["w_C"]], dim=-1)
    tail = torch.cat([x_pre, bc_pre], dim=-1)[:, -(cfg.d_conv - 1):, :]
    if S < cfg.d_conv - 1:
        tail = F.pad(tail, (0, 0, cfg.d_conv - 1 - S, 0))
    xi = _silu(_causal_conv(x_pre, p["conv_x"]))
    Bg, Cg = _silu(_causal_conv(bc_pre, p["conv_bc"])).chunk(2, dim=-1)
    Bh = Bg.reshape(B_, S, G, N).repeat_interleave(rep, dim=2)
    Ch = Cg.reshape(B_, S, G, N).repeat_interleave(rep, dim=2)
    xh = xi.reshape(B_, S, H, P)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final = ssd_scan(xh, Bh, Ch, dt, A, cfg.ssd_chunk, init_state)
    y = y + (p["D_skip"].float()[:, None] * xh.float()).to(y.dtype)
    y = y.reshape(B_, S, H * P)
    y = rms_norm(y * _silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], (final, tail)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, d_inner + 2*G*N)
    state: torch.Tensor   # (B, H, P, N)


def init_ssm_cache(cfg, batch: int, dtype, device, lead=()) -> SSMCache:
    """Zeroed conv window and state, with the leading axes ``lead`` (the
    stacked layers) before the batch."""
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.d_state
    ch = H * P + 2 * G * N
    return SSMCache(
        torch.zeros((*lead, batch, cfg.d_conv - 1, ch), dtype=dtype,
                    device=device),
        torch.zeros((*lead, batch, H, P, N), dtype=dtype, device=device))


def decode_ssm(x, p, cfg, cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode. x (B,1,D) -> (out (B,1,D), cache).

    The state steps in f32 and is stored back in the cache's dtype, as in
    the reference.  Unlike the reference, which returns a new cache, this
    writes ``cache.conv`` and ``cache.state`` in place and returns
    ``cache``."""
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.d_state
    B_ = x.shape[0]
    rep = H // G
    di = H * P
    z = (x @ p["w_z"])[:, 0]
    xbc_new = torch.cat([(x @ p["w_x"])[:, 0], (x @ p["w_B"])[:, 0],
                         (x @ p["w_C"])[:, 0]], dim=-1)
    window = torch.cat([cache.conv, xbc_new[:, None, :]], dim=1)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=1)
    conv_out = _silu(torch.einsum("bkc,kc->bc", window, conv_w))
    xi, Bg, Cg = conv_out.split([di, G * N, G * N], dim=-1)
    xh = xi.reshape(B_, H, P).float()
    Bh = Bg.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cg.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()
    dt = F.softplus((x @ p["w_dt"])[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    state = (cache.state.float() * torch.exp(dt * A)[:, :, None, None]
             + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + p["D_skip"][:, None] * xh
    y = y.reshape(B_, di).to(x.dtype)
    y = rms_norm(y * _silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None, :]
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache
