"""AdamW with global-norm clipping and a cosine schedule.  The reference's
error-feedback gradient compression (``optim/compression.py``) is not
ported yet (ROADMAP A16h-compress)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
