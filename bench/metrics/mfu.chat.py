"""Per-layer metric `mfu.chat`: see ``bench.readers.mfu``."""
from bench.readers import mfu as read  # noqa: F401
