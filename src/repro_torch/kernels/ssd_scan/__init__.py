from .ops import CUDA_LAUNCHES, ssd_scan  # noqa: F401
