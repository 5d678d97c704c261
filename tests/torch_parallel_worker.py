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
  trainloop  a TrainLoop with use_mesh on the job's data;
  spatial    the job's spatial scenarios (tests/test_torch_spatial.py): each
             an eval forward through make_spatial_forward over a spatial or a
             (data, spatial) mesh of the ranks, beside the one-process
             forward of the same model on the same image; then the refusals
             of shapes the meshes do not take.
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


def run_spatial(job, rank, world, group):
    import yaml

    from cerberusdet_tpu_torch.manager.weights import load_jax_params
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel
    from cerberusdet_tpu_torch.parallel import (
        make_data_spatial_mesh,
        make_spatial_forward,
        make_spatial_mesh,
    )
    from cerberusdet_tpu_torch.quant import calibrate_amax, quantize_params, select_all

    pair = None
    for ranks in ([0, 1], [2, 3])[:world // 2]:  # every rank makes both groups
        g = torch.distributed.new_group(ranks)
        if rank in ranks:
            pair = g
    cfgs = {}
    for name, cfg in job["cfgs"].items():
        cfgs[name] = os.path.join(job["tmp"], f"{name}.yaml")
        if rank == 0 and not isinstance(cfg, str):
            with open(cfgs[name], "w") as f:
                yaml.safe_dump(cfg, f)
        if isinstance(cfg, str):
            cfgs[name] = cfg
    torch.distributed.barrier()

    def model_of(sc):
        m = CerberusModel(cfgs[sc["cfg"]], job["tasks"], job["ncs"], device="cpu")
        load_jax_params(m, job["trees"][sc["cfg"]])
        m.eval().to(sc.get("dtype", torch.float64))
        if sc.get("int8"):
            m.fuse()
            amax = calibrate_amax(m, [sc["img"].permute(0, 2, 3, 1).numpy()])
            quantize_params(m, amax, select=select_all, propagate=True)
        return m

    def mesh_of(kind):
        if kind == "all":
            return make_spatial_mesh()
        if kind == "pair":
            return make_spatial_mesh(pair)
        return make_data_spatial_mesh(2)

    out = {}
    for name, sc in job["scenarios"].items():
        model = model_of(sc)
        mesh = mesh_of(sc["mesh"])
        dtype = sc.get("dtype", torch.float64)
        run = make_spatial_forward(model, mesh, tasks=sc.get("tasks"), dtype=dtype)
        got = run(sc["img"])
        with torch.no_grad():
            ref = model(sc["img"].to(dtype), tasks=sc.get("tasks"))
        out[name] = {"got": {t: p.numpy() for t, p in got.items()},
                     "ref": {t: p.numpy() for t, (p, _) in ref.items()},
                     "mesh": (mesh.index, mesh.size, mesh.data_index, mesh.data_size)}
    model = model_of({"cfg": "v8n"})
    errors = {}
    for label, kind, shape in (("h320", "all", (1, 3, 320, 256)),
                               ("batch3", "data", (3, 3, 256, 256))):
        try:
            make_spatial_forward(model, mesh_of(kind), dtype=torch.float32)(torch.zeros(shape))
        except ValueError as err:
            errors[label] = str(err)
    try:
        make_data_spatial_mesh(3)
    except ValueError as err:
        errors["n_spatial3"] = str(err)
    out["errors"] = errors
    return out


def main():
    mode, rank, world, init, job_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from cerberusdet_tpu_torch.parallel import init_distributed

    group = init_distributed(backend="gloo", device="cpu", init_method=f"file://{init}",
                             rank=rank, world_size=world)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    run = {"step": run_steps, "val": run_val, "trainloop": run_trainloop,
           "spatial": run_spatial}[mode]
    out = run(job, rank, world, group)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
