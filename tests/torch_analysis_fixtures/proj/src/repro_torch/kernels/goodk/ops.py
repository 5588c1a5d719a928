"""overflow-range NEGATIVE: the raising guard bounds every extent passed at
a ctypes.c_int argument and the element count of the operand the entry
indexes in 32 bits (``x.numel()`` is the product of x's unpacked dims)."""
import ctypes

from .. import load_kernel

_I32_MAX = 2**31 - 1


def launch(x, out, steps):
    B, W = x.shape
    n = x.numel()
    if max(B, n) > _I32_MAX or not 0 <= steps <= _I32_MAX:
        raise ValueError("extents past the kernel's int arguments")
    fn = load_kernel("goodk").goodk_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return fn(x.data_ptr(), out.data_ptr(), B, n, steps, None)
