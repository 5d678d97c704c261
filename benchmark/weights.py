"""Seeded weights and frames, made on the device from `--seed`.

Weights: every conv weight from one normal draw, scaled by gain / sqrt(fan_in)
(GAIN for the SiLU convs, so that activations neither vanish nor blow up with
depth); BatchNorm running statistics taken from the calibration frames, one
layer after another, so that each conv's output is centred and of unit
variance on them; the Detect towers' last 1x1 from the same draw, scaled so
that their logits spread by BOX_STD and CLS_STD on the calibration frames,
the box bias 0, and each classification bias set so that a fraction
CANDIDATE_SHARE of the (anchor, class) scores of the frames the cell serves
lies above SCORE_AT: every seed's weights then give its frames the same
number of candidates, and about as many detections. The family's reference
computes the statistics, in float32 (TF32 off); the program gets the
finished dict. The recipe reads the program's parameter names: `<conv>.w`
and `<conv>.bn.*` of a Conv, `.2.w` a tower's last 1x1 (no SiLU follows),
`.m.<i>.cv2` a bottleneck's last Conv, `blocks.head_<task>.{box,cls}<level>`
the Detect towers; a family whose names keep these takes it whole
(families/yolov8.py).

Frames: BGR uint8 (B, H, W, 3) fields of coarse blobs, finer texture and
pixel noise, so that the features and the detections vary over the frame.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

GAIN = 1.677          # 1 / sqrt(E[silu(z)^2]) for z ~ N(0, 1)
BN_GAMMA = 0.15       # BatchNorm weight: SiLU near its linear part (perturbations neither grow nor fade)
BN_M = 0.1            # a further factor on the bottlenecks' last conv: near-identity residual branches
BOX_STD = 2.0         # std of the box (DFL) logits on the calibration frames
CLS_STD = 2.5         # std of the class logits on the calibration frames
CANDIDATE_SHARE = 2e-4
SCORE_AT = 0.25


def frames(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """n seeded BGR uint8 frames (n, h, w, 3) on `device`."""
    def field(ch, cw):
        x = torch.rand((n, 3, ch, cw), generator=gen, device=device)
        return F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False)
    x = 0.55 * field(6, 8) + 0.3 * field(h // 16, w // 16) \
        + 0.15 * torch.rand((n, 3, h, w), generator=gen, device=device)
    return (x.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def make_weights(shapes: Dict[str, tuple], reference: Callable, gen: torch.Generator,
                 calib: torch.Tensor, served=None) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on calib's device. shapes: the family's
    param_shapes; reference(weights): the family's float32 Reference over
    them; calib: (B, 3, H, W) in [0, 1]; served: the frames the cell serves,
    as a callable that yields such batches (the classification biases are set
    on them; on calib when None)."""
    dev = calib.device
    conv_names = [k for k, s in shapes.items() if k.endswith(".w")]
    sizes = [math.prod(shapes[k]) for k in conv_names]
    draw = (torch.rand(sum(sizes), generator=gen, device=dev) * 2 - 1).mul_(math.sqrt(3)).split(sizes)
    out: Dict[str, torch.Tensor] = {}
    for k, d in zip(conv_names, draw):
        shape = shapes[k]
        fan = math.prod(shape[1:])
        gain = 1.0 if k.endswith(".2.w") else GAIN
        out[k] = d.view(shape) * (gain / math.sqrt(fan))
    for k, shape in shapes.items():
        if k in out:
            continue
        one = k.endswith("bn.weight") or k.endswith("running_var")
        out[k] = (torch.ones if one else torch.zeros)(shape, device=dev)
    ref = reference(out)

    def take_stats(p, y):
        out[f"{p}.bn.running_var"].copy_(y.square().mean((0, 2, 3)))
        out[f"{p}.bn.weight"].fill_(BN_GAMMA * (BN_M if ".m." in p and p.endswith("cv2") else 1.0))

    ref.bn_hook = take_stats
    maps = ref.features(calib)
    ref.bn_hook = None
    for t, ms in maps.items():
        for i, m in enumerate(ms):
            box, cls = m[:, :4 * 16].float(), m[:, 4 * 16:].float()
            out[f"blocks.head_{t}.box{i}.2.w"].mul_(BOX_STD / float(box.std()))
            out[f"blocks.head_{t}.cls{i}.2.w"].mul_(CLS_STD / float(cls.std()))
    del maps
    ref = reference(out)  # the scaled towers
    logits = {}  # (task, level) -> the class logits of every served frame, bias 0
    for x in (served() if served is not None else [calib]):
        for t, ms in ref.features(x).items():
            for i, m in enumerate(ms):
                logits.setdefault((t, i), []).append(m[:, 4 * 16:].float().reshape(-1))
    logit_at = math.log(SCORE_AT / (1 - SCORE_AT))
    for (t, i), parts in logits.items():
        q = torch.quantile(torch.cat(parts)[:2 ** 24], 1 - CANDIDATE_SHARE)
        out[f"blocks.head_{t}.cls{i}.2.b"].fill_(logit_at - float(q))
    return out
