from .ops import (BWD_KERNELS, CUDA_LAUNCHES,  # noqa: F401
                  ssd_bwd_chunk, ssd_bwd_state, ssd_scan, ssd_scan_bwd)
