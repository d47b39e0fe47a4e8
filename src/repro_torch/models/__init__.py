"""Models: the dense decoder-only, encoder-decoder, SSM (Mamba2), hybrid
(Zamba2), MoE and VLM families (config, parameters, forward and loss,
prefill, cached decode), and the logical axes trees that place their
parameters and caches on a mesh (``param_axes``, ``cache_axes``)."""
from repro_torch.models.transformer import (ModelConfig, cache_axes,
                                            decode_step, forward,
                                            init_params, lm_loss,
                                            make_decode_caches, param_axes,
                                            prefill)

__all__ = ["ModelConfig", "cache_axes", "decode_step", "forward",
           "init_params", "lm_loss", "make_decode_caches", "param_axes",
           "prefill"]
