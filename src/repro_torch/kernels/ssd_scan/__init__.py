from .ops import ssd_scan  # noqa: F401
