"""Shared transformer building blocks: norms, RoPE, MLPs, embeddings.

Pure functions over parameter dicts, with weights in the reference's
``(d_in, d_out)`` orientation so ``x @ w`` is its ``einsum``.  The casts sit
where the reference has them: norms, RoPE and the MLP's activation in f32,
then back to the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_table(positions, d_head: int, theta: float):
    """positions (...,S) -> cos/sin tables (...,S, d_head/2), f32."""
    half = d_head // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x (B,S,H,D); cos/sin (B,S,half) or (S,half). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def normal(shape, dtype, scale, generator, device):
    """``normal * scale`` drawn in f32, then cast."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


# --- MLP ---------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, act: str, dtype, generator,
             device) -> dict:
    mult = 2 if act == "swiglu" else 1
    return {
        "w_in": normal((d_model, mult * d_ff), dtype, d_model ** -0.5,
                       generator, device),
        "w_out": normal((d_ff, d_model), dtype, d_ff ** -0.5, generator,
                        device),
    }


def mlp_axes() -> dict:
    """Logical axes of :func:`init_mlp`'s leaves."""
    return {"w_in": ("wt_fsdp", "ff"), "w_out": ("ff", "wt_fsdp")}


def apply_mlp(x, p, act: str):
    h = x @ p["w_in"]
    if act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return h @ p["w_out"]


# --- Embedding / head --------------------------------------------------------

def init_embed(vocab: int, d_model: int, dtype, tie: bool, generator,
               device) -> dict:
    p = {"tok": normal((vocab, d_model), dtype, 1.0, generator, device)}
    if not tie:
        p["head"] = normal((d_model, vocab), dtype, d_model ** -0.5,
                           generator, device)
    return p


def embed_axes(tie: bool) -> dict:
    """Logical axes of :func:`init_embed`'s leaves."""
    p = {"tok": ("vocab", "wt_fsdp")}
    if not tie:
        p["head"] = ("wt_fsdp", "vocab")
    return p


def embed_tokens(tokens, p, dtype):
    return p["tok"][tokens].to(dtype)


def lm_logits(x, p, true_vocab: int | None = None):
    """Logits in the model's dtype; columns past ``true_vocab`` (the padded
    vocab) get -1e30 added in that dtype, as the reference adds its mask."""
    w = p.get("head")
    if w is None:
        w = p["tok"].T
    logits = x @ w
    if true_vocab is not None and true_vocab < w.shape[-1]:
        cols = torch.arange(w.shape[-1], device=logits.device)
        pad_mask = torch.where(cols < true_vocab, 0.0, -1e30)
        logits = logits + pad_mask.to(logits.dtype)
    return logits
