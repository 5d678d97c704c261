"""The convolutions' least time over the conv kernels' device time
(benchmark/readers.py:conv_roofline)."""

from benchmark.readers import conv_roofline


def read(ctx):
    return conv_roofline(ctx)
