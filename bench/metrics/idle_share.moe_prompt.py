"""Per-layer metric `idle_share.moe_prompt`: see ``bench.readers.idle_share``."""
from bench.readers import idle_share as read  # noqa: F401
