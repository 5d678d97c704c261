"""Export a .ckpt.npz checkpoint to the reference's torch state-dict .pt
format: the inverse of convert_to_cerber / manager/pt_import.py, so that
models trained by either package can be consumed by the reference codebase.

    python -m cerberusdet_tpu_torch.tools.export_to_pt \
        --weights runs/train/exp/weights/best.ckpt.npz \
        --out exported.pt [--use-ema]

Counterpart of cerberusdet_tpu/tools/export_to_pt.py. Runs on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="source .ckpt.npz")
    p.add_argument("--out", required=True, help="output .pt (bare state dict)")
    p.add_argument("--use-ema", action="store_true",
                   help="export the EMA weights (attempt_load's preference)")
    args = p.parse_args(argv)

    from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint
    from cerberusdet_tpu_torch.manager.pt_export import export_pt
    from cerberusdet_tpu_torch.manager.weights import load_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    ckpt = load_checkpoint(args.weights)
    meta = ckpt["meta"]
    model = CerberusModel(meta["cfg"], meta["task_ids"], meta["nc"], device="cpu")
    params = ckpt["ema"] if args.use_ema and ckpt.get("ema") else ckpt["params"]
    export_pt(load_jax_params(model, params), args.out)
    print(f"exported {args.weights} -> {args.out} "
          f"(tasks={meta['task_ids']}, nc={meta['nc']})")


if __name__ == "__main__":
    main()
