from .ops import bna_decompose  # noqa: F401
