from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               complete_steps, latest_step,
                                               restore_latest_valid,
                                               restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "complete_steps", "latest_step",
           "restore_latest_valid", "restore_pytree", "save_pytree"]
