"""Per-layer metric `mfu.moe_prompt`: see ``bench.readers.mfu``."""
from bench.readers import mfu as read  # noqa: F401
