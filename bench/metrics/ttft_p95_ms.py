"""End-to-end metric `ttft_p95_ms`: see ``bench.readers.ttft_p95_ms``."""
from bench.readers import ttft_p95_ms as read  # noqa: F401
