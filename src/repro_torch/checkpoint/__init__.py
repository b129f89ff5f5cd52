from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint"]
