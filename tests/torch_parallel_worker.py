"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py <mode> <rank> <world> <init file> <job.pkl> <out.pkl>

Joins a Gloo group of `world` ranks on the CPU through the file:// init
method (no ports, so no races between test workers), runs `mode` on the job
the test pickled, and pickles its results. It imports torch and the port
only (no JAX), as a rank of the port's training or val would.

Modes:
  step       the float64 train steps of the job's scenarios, each from the
             job's initial parameters: "split", this rank's rows of each
             global batch; "padded", rank 0 the first `n0` rows (img_mask all
             ones), the others the rest, padded to n0 by pad_batch_to;
  val        distributed run_task of each task's val set (host-sharded rect
             loaders), from the job's parameter tree;
  trainloop  a TrainLoop with use_mesh on the job's data.
"""

import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def run_steps(job, rank, world, group):
    from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.parallel import pad_batch_to, replicate, shard_task_batches
    from cerberusdet_tpu_torch.train.loss import DetectionLoss
    from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

    tasks, ncs = job["tasks"], job["ncs"]
    out = {}
    for name, batches in job["scenarios"].items():
        model = CerberusModel(CFG, tasks, ncs, device="cpu").double()
        load_jax_params(model, job["init"])
        losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(tasks, ncs)}
        trainer = MultiTaskTrainer(model, losses, compute_dtype=torch.float64, device="cpu",
                                   group=group)
        state = replicate(init_train_state(model), group)
        if name == "padded":
            n0 = job["n0"]
            local = {t: {k: v[:n0] if rank == 0 else v[n0:] for k, v in b.items()}
                     for t, b in batches.items()}
            local = {t: pad_batch_to(b, n0) for t, b in local.items()}
        else:
            local = shard_task_batches(batches, world, index=rank)
        items = []
        for lrs, mom in job["schedule"]:
            state, it = trainer.step(state, local, lrs, mom)
            items.append({t: [float(x) for x in v] for t, v in it.items()})
        out[name] = {"items": items, "params": _numpy(export_jax_params(model)),
                     "ema": _numpy(export_jax_params(state.ema))}
    return out


def run_val(job, rank, world, group):
    from cerberusdet_tpu_torch.data.loaders import create_dataloader
    from cerberusdet_tpu_torch.evaluation.val import run_task
    from cerberusdet_tpu_torch.manager.weights import load_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    model = load_jax_params(CerberusModel(CFG, job["tasks"], job["ncs"], device="cpu"),
                            job["tree"]).double()
    out = {}
    for task, nc in zip(job["tasks"], job["ncs"]):
        _, loader = create_dataloader(job["val_sets"][task], 64, 4, rect=True, pad=0.5,
                                      task=f"{task}_val", max_labels=16,
                                      cache_dir=os.path.join(job["cache"], f"r{rank}"))
        res = run_task(model, task, loader, nc, plots=True, distributed=True)
        out[task] = {"results": list(res["results"]), "maps": res["maps"],
                     "fitness": res["fitness"], "seen": res["seen"],
                     "confusion": res["confusion"].matrix,
                     "shapes": [t[0] for t in res["times"]],
                     "n_stats": len(res["metrics"].stats)}
    return out


def run_trainloop(job, rank, world, group):
    import yaml

    from cerberusdet_tpu_torch.train import trainer as port_trainer

    with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")) as f:
        hyp = yaml.safe_load(f)
    opt = port_trainer.TrainOptions(**job["options"])
    port_trainer.RunManager.tb_writer = lambda self: None  # TensorBoard would pull TensorFlow
    loop = port_trainer.TrainLoop(opt, job["data"], hyp, device="cpu")
    fi = loop.train()
    w = loop.manager.wdir / "last.ckpt.npz"
    return {"fitness": fi, "nb": loop.nb, "save_dir": str(loop.manager.save_dir),
            "ckpt_written": w.exists() and rank == 0,
            "steps": len(loop.timings), "rows": [len(ld.sampler) for ld in
                                                 loop.train_loaders.values()],
            "params": {k: v.detach().numpy().copy()
                       for k, v in loop.state.model.state_dict().items()}}


def main():
    mode, rank, world, init, job_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from cerberusdet_tpu_torch.parallel import init_distributed

    group = init_distributed(backend="gloo", device="cpu", init_method=f"file://{init}",
                             rank=rank, world_size=world)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    run = {"step": run_steps, "val": run_val, "trainloop": run_trainloop}[mode]
    out = run(job, rank, world, group)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
