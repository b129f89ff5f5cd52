"""Per-layer metric `decode_step_ms.chat`: see ``bench.readers.decode_step_ms``."""
from bench.readers import decode_step_ms as read  # noqa: F401
