"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) ff_expert=1536
vocab151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv=4, d_head=128, d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, act="swiglu", qk_norm=True, rope_theta=1e6,
    dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=32,
    n_experts=4, top_k=2, vocab=256, attn_q_chunk=16, attn_kv_chunk=16,
    loss_chunk=32, dtype="float32")
