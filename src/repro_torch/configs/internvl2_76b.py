"""internvl2-76b [vlm] — 80L d8192 64H (GQA kv=8) ff28672 vocab128256 —
InternViT + InternLM2/LLaMA3-70B backbone [arXiv:2404.16821; unverified]

Backbone only: the InternViT frontend is a stub — the caller supplies
precomputed patch embeddings (``embeds``, B x ``prefix_len`` x d_model)
that occupy the first ``prefix_len`` positions.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, d_head=128, d_ff=28672, vocab=128256,
    act="swiglu", rope_theta=5e5, input_mode="embeds_prefix",
    prefix_len=1024, dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=256, prefix_len=4, attn_q_chunk=16, attn_kv_chunk=16,
    loss_chunk=32, dtype="float32")
