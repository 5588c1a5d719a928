from .pipeline import (DataConfig, SyntheticTokens,  # noqa: F401
                       make_batch_specs)
