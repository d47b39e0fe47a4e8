"""qwen3-1.7b [dense] — 28L d2048 16H (GQA kv=8) ff6144 vocab151936 —
qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv=8, d_head=128, d_ff=6144, vocab=151936,
    act="swiglu", qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=256, attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32,
    dtype="float32")
