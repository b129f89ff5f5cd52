"""End-to-end metric `peak_mem_gib`: see ``bench.readers.peak_mem_gib``."""
from bench.readers import peak_mem_gib as read  # noqa: F401
