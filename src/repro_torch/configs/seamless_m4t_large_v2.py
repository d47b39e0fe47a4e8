"""seamless-m4t-large-v2 [audio] — enc-dec, 24L/stack d1024 16H (kv=16 = MHA)
ff8192 vocab256206 [arXiv:2308.11596; hf]

Backbone only: the speech frontend is a stub — the caller supplies
precomputed frame embeddings (B, S, d_model). Encoder 24L bidirectional,
decoder 24L causal + cross-attention.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    n_enc_layers=24, d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=8192, vocab=256206, act="gelu", rope_theta=10000.0,
    input_mode="frames", dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=32, n_heads=4, n_kv=4,
    d_head=8, d_ff=64, vocab=256, attn_q_chunk=16, attn_kv_chunk=16,
    loss_chunk=32, dtype="float32")
