"""Models: the dense decoder-only, encoder-decoder, SSM (Mamba2) and hybrid
(Zamba2) families (config, parameters, forward and loss, prefill, cached
decode).  The MoE and VLM families and the sharding specs are not ported
yet (ROADMAP A16)."""
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            forward, init_params, lm_loss,
                                            make_decode_caches, prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_params",
           "lm_loss", "make_decode_caches", "prefill"]
