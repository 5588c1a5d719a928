from .ops import bna_step, stage_state  # noqa: F401
