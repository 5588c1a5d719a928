from .ops import coflow_merge, edge_interval_alphas, interval_alphas  # noqa: F401
