"""Staged body whose own body is clean (passes the syntactic jit-purity
rule) but which hands a traced tensor to :func:`repro_torch.core.helper.
pick`, where a Python branch consumes it — only the interprocedural taint
engine sees that."""
import torch

from .helper import pick


def step(x, n):
    if x.size(0) > 4:  # tracer-taint NEGATIVE: shapes are Python values
        y = torch.cumsum(x, 0)
    else:
        y = torch.cumsum(x, 0) * 2
    return pick(y, n)


step_staged = torch.func.vmap(step, in_dims=(0, None))
