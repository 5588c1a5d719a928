from .ops import (attn_bwd_dkdv, attn_bwd_dq, attn_bwd_prep,  # noqa: F401
                  flash_attention, flash_attention_bwd, flash_attention_lse,
                  forward_kernel)
