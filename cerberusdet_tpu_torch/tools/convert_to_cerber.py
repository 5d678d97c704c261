"""Convert reference .pt weights (e.g. a single-task YOLOv8 state dict) into
a .ckpt.npz checkpoint for 1..N tasks; head weights are duplicated to every
task.

    python -m cerberusdet_tpu_torch.tools.convert_to_cerber --weights yolov8x.pt \
        --cfg configs/models/yolov8x_2task.yaml --data data.yaml --out w.ckpt.npz

Counterpart of cerberusdet_tpu/tools/convert_to_cerber.py (the reference's
convert_to_cerber.py:69-103). Runs on the CPU.
"""

from __future__ import annotations

import argparse


def convert(weights: str, cfg: str, task_ids, nc, out_path: str,
            names=None, verbose: bool = True) -> str:
    from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
    from cerberusdet_tpu_torch.manager.pt_import import import_pt
    from cerberusdet_tpu_torch.manager.weights import export_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    model = CerberusModel(cfg, task_ids, nc, device="cpu").init(0)
    import_pt(model, weights, verbose=verbose)
    meta = {
        "epoch": -1,
        "task_ids": list(task_ids),
        "nc": list(nc),
        "names": [list(n) for n in (names or [[str(i) for i in range(c)] for c in nc])],
        "cfg": str(cfg),
        "converted_from": str(weights),
    }
    save_checkpoint(out_path, export_jax_params(model), meta)
    if verbose:
        print(f"converted {weights} -> {out_path}")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="source yolov8 .pt")
    p.add_argument("--cfg", required=True, help="target model yaml (may include cerber)")
    p.add_argument("--data", required=True, help="data yaml (task_ids/nc/names)")
    p.add_argument("--out", required=True, help="output .ckpt.npz")
    opt = p.parse_args(argv)
    from cerberusdet_tpu_torch.manager.run_manager import parse_data_config

    d = parse_data_config(opt.data)
    convert(opt.weights, opt.cfg, d["task_ids"], d["nc"], opt.out, d["names"])


if __name__ == "__main__":
    main()
