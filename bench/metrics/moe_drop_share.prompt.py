"""Per-layer metric `moe_drop_share.prompt`: see ``bench.recorded.moe_drop_share``."""
from bench.recorded import moe_drop_share as read  # noqa: F401
