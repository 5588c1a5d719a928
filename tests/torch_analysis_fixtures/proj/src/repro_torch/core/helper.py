"""Helper called from a staged body in staged.py.  On its own this file is
innocent — no torch import, no staging call — which is exactly why the
syntactic jit-purity rule never looks at it.  The taint engine follows the
traced tensor into ``pick`` and flags the branch."""


def pick(y, n):
    if y[0] > 0:  # tracer-taint POSITIVE: Python branch on a traced value
        return y * 2
    total = 0
    for i in range(n):  # negative: n is passed through by vmap (in_dims None)
        total += i
    return y + total
