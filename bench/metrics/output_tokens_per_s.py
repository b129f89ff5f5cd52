"""End-to-end metric `output_tokens_per_s`: see ``bench.readers.output_tokens_per_s``."""
from bench.readers import output_tokens_per_s as read  # noqa: F401
