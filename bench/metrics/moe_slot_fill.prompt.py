"""Per-layer metric `moe_slot_fill.prompt`: see ``bench.readers.moe_slot_fill``."""
from bench.readers import moe_slot_fill as read  # noqa: F401
