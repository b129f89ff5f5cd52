"""Per-layer metric `idle_share.prompt`: see ``bench.readers.idle_share``."""
from bench.readers import idle_share as read  # noqa: F401
