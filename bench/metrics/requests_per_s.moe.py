"""End-to-end metric `requests_per_s.moe`: ``requests_per_s`` in the moe
cells, apart because their host-paced decode steps spread it five times
wider; see ``bench.readers.requests_per_s``."""
from bench.readers import requests_per_s as read  # noqa: F401
