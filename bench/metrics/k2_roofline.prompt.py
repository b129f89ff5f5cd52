"""Per-layer metric `k2_roofline.prompt`: see ``bench.readers.k2_roofline``."""
from bench.readers import k2_roofline as read  # noqa: F401
