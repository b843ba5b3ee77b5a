from repro_torch.checkpoint.ckpt import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]
