from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.elastic import reshard_state

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "reshard_state"]
