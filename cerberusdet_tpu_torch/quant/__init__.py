"""Post-training int8 quantization for serving (quant/ptq.py)."""

from cerberusdet_tpu_torch.quant.ptq import (
    calibrate_amax,
    conv_layers,
    fused_conv_weights,
    quantize_params,
    select_all,
    select_deep,
)

__all__ = ["calibrate_amax", "conv_layers", "fused_conv_weights", "quantize_params",
           "select_all", "select_deep"]
