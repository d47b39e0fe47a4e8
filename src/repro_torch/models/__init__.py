"""Models: the dense decoder-only family (config, parameters, prefill, KV-cache
decode).  Other families, the loss and the sharding specs are not ported
yet (ROADMAP A16)."""
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            forward, init_params,
                                            make_decode_caches, prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_params",
           "make_decode_caches", "prefill"]
