"""Strip optimizer / EMA from run checkpoints (reference: strip_weights.py:8-37).

The port's counterpart of cerberusdet_tpu/tools/strip_weights.py, over
manager/checkpoint.py:strip_checkpoint (EMA promoted to the params, no
momentum, float32 leaves written as float16):

    python -m cerberusdet_tpu_torch.tools.strip_weights --weights runs/train/exp/weights \
        [--out stripped.ckpt.npz]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="ckpt file or run weights dir")
    p.add_argument("--out", default="", help="optional output path")
    opt = p.parse_args(argv)
    from cerberusdet_tpu_torch.manager.checkpoint import strip_checkpoint

    path = Path(opt.weights)
    targets = sorted(path.glob("*.ckpt.npz")) if path.is_dir() else [path]
    for t in targets:
        strip_checkpoint(t, opt.out or None)
        print(f"stripped {t}")


if __name__ == "__main__":
    main()
