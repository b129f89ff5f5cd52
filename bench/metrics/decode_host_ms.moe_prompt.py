"""Per-layer metric `decode_host_ms.moe_prompt`: see ``bench.recorded.decode_host_ms``."""
from bench.recorded import decode_host_ms as read  # noqa: F401
