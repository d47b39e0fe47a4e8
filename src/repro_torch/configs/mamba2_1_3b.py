"""mamba2-1.3b [ssm] — 48L d2048 (attn-free) vocab50280, ssm_state=128 — SSD
[arXiv:2405.21060; unverified]

d_inner = 2*2048 = 4096; head_dim 64 -> 64 SSD heads; 8 B/C groups.
"""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    vocab=50280, d_state=128, d_conv=4, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=8, ssd_chunk=256, tie_embeddings=True, dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, d_state=16, ssm_head_dim=16,
    ssm_groups=2, ssd_chunk=8, vocab=256, loss_chunk=32, dtype="float32")
