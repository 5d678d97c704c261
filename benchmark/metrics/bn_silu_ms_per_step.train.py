"""Device ms a step of the BatchNorm + SiLU kernels (csrc/bn_silu.cu, through
ops/bn_cuda.py), over the traced window's steps: each kernel's mean recorded
launch times the launches its wrapper counted (benchmark/readers.py:
bn_silu_seconds)."""

from benchmark.readers import bn_silu_seconds


def read(ctx):
    s = bn_silu_seconds(ctx)
    return None if s is None else 1e3 * s / ctx.traced["steps"]
