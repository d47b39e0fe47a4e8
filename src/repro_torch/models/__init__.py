"""Models: the dense decoder-only, encoder-decoder, SSM (Mamba2), hybrid
(Zamba2), MoE and VLM families (config, parameters, forward and loss,
prefill, cached decode).  The sharding specs are not ported yet (ROADMAP
A16i)."""
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            forward, init_params, lm_loss,
                                            make_decode_caches, prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_params",
           "lm_loss", "make_decode_caches", "prefill"]
