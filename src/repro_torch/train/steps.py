"""Serving's step functions: prefill and one decode step."""
from __future__ import annotations

from repro_torch.models import ModelConfig, decode_step, prefill


def make_prefill_fn(cfg: ModelConfig, max_len: int):
    def prefill_fn(params, batch: dict):
        return prefill(params, cfg, batch["tokens"], max_len)
    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    def decode_fn(params, tokens, caches):
        return decode_step(params, cfg, tokens, caches)
    return decode_fn
