from .ops import merge_fix, merge_fix_step  # noqa: F401
