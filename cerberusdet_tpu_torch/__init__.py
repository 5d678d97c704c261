"""CerberusDet in PyTorch for NVIDIA Hopper (H100).

The port of `cerberusdet_tpu` (JAX on a TPU, kept unchanged beside it as the
reference). Module paths mirror the JAX package's, so `cerberusdet_tpu/X.py`
has its counterpart at `cerberusdet_tpu_torch/X.py`. Tensors are NCHW, conv
weights OIHW; the public `predict` keeps the JAX contract (an NHWC float batch
in [0, 1] in, per-image detection dicts out).

Entry points run on the card ("cuda") unless the caller passes device="cpu".
"""


def resolve_device(device=None):
    """`None` means the card. Raises when the card is asked for and absent."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return device
