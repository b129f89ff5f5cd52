"""End-to-end metric `requests_per_s`: see ``bench.readers.requests_per_s``."""
from bench.readers import requests_per_s as read  # noqa: F401
