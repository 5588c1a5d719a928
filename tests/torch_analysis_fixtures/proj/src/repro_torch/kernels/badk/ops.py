"""overflow-range POSITIVE that the syntactic overflow-guard rule accepts:
a sentinel guard that raises *exists* (so overflow-guard is happy), but it
bounds the batch alone while the launch passes ``x.numel()`` at a
ctypes.c_int argument — unprovable, and a silent wrong extent for a tensor
of more than 2**31 - 1 elements (ctypes wraps the int)."""
import ctypes

from .. import load_kernel

_I32_MAX = 2**31 - 1


def _launch(fn, name, *args):
    return fn(*args, 0)


def launch(x):
    B = x.shape[0]
    if B > _I32_MAX:
        raise ValueError("batch exceeds int32")
    fn = load_kernel("badk").badk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return _launch(fn, "badk", x.data_ptr(), B, x.numel())
