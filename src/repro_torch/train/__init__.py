"""Step functions.  Only serving's prefill and decode are ported; training
waits for the backward kernels (ROADMAP A16h, B3, B4)."""
from repro_torch.train.steps import make_decode_fn, make_prefill_fn

__all__ = ["make_decode_fn", "make_prefill_fn"]
