from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "wsd_schedule", "cosine_schedule"]
