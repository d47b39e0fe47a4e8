"""AdamW with global-norm clipping and a cosine schedule, and the
error-feedback gradient compression of the cross-pod step."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, cosine_schedule,
                                     global_norm)
from repro_torch.optim.compression import ef_compress_update, init_ef_state

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "ef_compress_update",
           "init_ef_state"]
