from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree"]
