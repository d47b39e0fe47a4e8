"""Models: the dense decoder-only, encoder-decoder, SSM (Mamba2), hybrid
(Zamba2) and MoE families (config, parameters, forward and loss, prefill,
cached decode).  The VLM family and the sharding specs are not ported yet
(ROADMAP A16g, A16i)."""
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            forward, init_params, lm_loss,
                                            make_decode_caches, prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_params",
           "lm_loss", "make_decode_caches", "prefill"]
