"""zamba2-7b [hybrid] — 81L d3584 32H (GQA kv=32) ff14336 vocab32000,
ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified]

Layout here: 13 groups of [1 shared attn+MLP block + 5 Mamba2 layers] + 3
tail Mamba2 layers = 81 layers, 13 shared-attn applications (one weight set).
The per-application LoRA adapters of the real model are omitted, as in the
reference's config.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv=32, d_head=112, d_ff=14336, vocab=32000,
    d_state=64, d_conv=4, ssm_head_dim=64, ssm_expand=2, ssm_groups=8,
    ssd_chunk=256, hybrid_group=6, act="swiglu", dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=7, hybrid_group=3, d_model=64, n_heads=4, n_kv=4,
    d_head=16, d_ff=128, d_state=16, ssm_head_dim=16, ssm_groups=2,
    ssd_chunk=8, vocab=256, attn_q_chunk=16, attn_kv_chunk=16,
    loss_chunk=32, dtype="float32")
