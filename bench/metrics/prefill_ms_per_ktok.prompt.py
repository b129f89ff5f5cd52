"""Per-layer metric `prefill_ms_per_ktok.prompt`: see ``bench.readers.prefill_ms_per_ktok``."""
from bench.readers import prefill_ms_per_ktok as read  # noqa: F401
