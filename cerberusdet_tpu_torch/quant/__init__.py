"""Post-training int8 quantization for serving (quant/ptq.py)."""

from cerberusdet_tpu_torch.quant.ptq import (
    act_quant_annotations,
    calibrate_amax,
    clear_act_quant,
    conv_layers,
    fused_conv_weights,
    propagate_act_quant,
    quantize_params,
    select_all,
    select_deep,
)

__all__ = ["act_quant_annotations", "calibrate_amax", "clear_act_quant", "conv_layers",
           "fused_conv_weights", "propagate_act_quant", "quantize_params", "select_all",
           "select_deep"]
