"""phi4-mini-3.8b [dense] — 32L d3072 24H (GQA kv=8) ff8192 vocab200064 —
RoPE SwiGLU GQA [arXiv:2412.08905; hf]"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv=8, d_head=128, d_ff=8192, vocab=200064,
    act="swiglu", rope_theta=10000.0, tie_embeddings=True, dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv=2, d_head=12, d_ff=96,
    vocab=256, attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32,
    dtype="float32")
