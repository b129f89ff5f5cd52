"""Per-layer metric `k1_roofline.prompt`: see ``bench.readers.k1_roofline``."""
from bench.readers import k1_roofline as read  # noqa: F401
