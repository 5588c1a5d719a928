from .ops import bna_step, stage_int32  # noqa: F401
