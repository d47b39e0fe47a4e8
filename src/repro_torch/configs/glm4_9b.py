"""glm4-9b [dense] — 40L d4096 32H (GQA kv=2) ff13696 vocab151552 — RoPE, GQA
[hf:THUDM/glm-4-9b; hf]"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv=2, d_head=128, d_ff=13696, vocab=151552,
    act="swiglu", rope_theta=10000.0, dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=1, d_head=16, d_ff=128,
    vocab=256, attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32,
    dtype="float32")
