"""Serving entry point of the port: an HTTP detection service with dynamic
request batching over the captured inference program.

    python -m cerberusdet_tpu_torch.cli.serve \
        --weights runs/train/exp/weights/best.ckpt.npz \
        --port 8000 --max-batch 8 --int8 all

    curl -X POST --data-binary @image.jpg localhost:8000/predict
    curl localhost:8000/stats

/stats returns the engine's cumulative counters (serve/server.py): requests,
batches, errors, rows, padded_rows, queue_ms_sum and latency_ms_sum, which
only grow; a window's rate, batch fill or mean wait is the difference of two
reads (mean latency = change in latency_ms_sum / change in requests).

Counterpart of the JAX package's serve.py, with its flags and defaults,
except that --platform gives way to --device (the card, "cuda", by default;
"cpu" runs on the CPU) and --compile-cache goes (the port compiles no
program ahead; each key's CUDA graph is captured at its first request).
--mesh serves data-parallel over every visible card (the JAX package's
mesh, parallel/mesh.py:make_mesh; with --device cpu, over the CPU): the
model is replicated on each, and each served batch of --max-batch rows,
which must divide by the number of cards, is split over the replicas
(infer/inference.py). The service warms up before it accepts
traffic: the batch of --max-batch that every served batch is padded to is
captured at construction, and one dummy request passes the engine.
"""

from __future__ import annotations

import argparse


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="a .ckpt.npz written by either package")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--iou-thres-between-tasks", type=float, default=0.8)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--bf16", "--half", action="store_true", dest="bf16")
    p.add_argument("--int8", default="off", choices=["off", "deep", "all"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="the one served batch shape; partial batches are padded "
                        "to it, so every request replays one captured program")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batch-fill wait after the first request arrives")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel serving over every visible card: the model "
                        "replicates, each served batch splits over the cards "
                        "(max-batch must divide by the card count)")
    p.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    return p.parse_args(argv)


def build(opt):
    """(inference, engine, server) for the parsed options: the model loaded
    and warmed up at --max-batch, the batching engine running, and the HTTP
    server bound but not yet serving."""
    import numpy as np
    import torch

    from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
    from cerberusdet_tpu_torch.serve import BatchingEngine, make_server

    mesh = None
    if opt.mesh:
        from cerberusdet_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(None if torch.device(opt.device).type == "cuda" else [opt.device])
        if opt.max_batch % len(mesh):
            raise SystemExit(f"--max-batch {opt.max_batch} must divide by the "
                             f"{len(mesh)}-device mesh")
        print(f"serving over a {len(mesh)}-device data mesh ({mesh[0].type})", flush=True)
    inference = CerberusDetInference(
        weights=opt.weights, conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
        iou_thres_between_tasks=opt.iou_thres_between_tasks,
        img_size=opt.imgsz, half=opt.bf16, max_det=opt.max_det, int8=opt.int8,
        device=None if mesh else opt.device, mesh=mesh,
        # every served batch pads to max_batch: capture that shape, not batch 1
        warmup_batch=opt.max_batch)
    pre = CerberusPreprocessor(img_size=opt.imgsz, stride=32, device=inference.device)
    engine = BatchingEngine(inference, pre, max_batch=opt.max_batch,
                            max_wait_ms=opt.max_wait_ms)
    tasks = list(inference.names)
    # one dummy request through the engine before accepting traffic, so that
    # the first clients do not wait for the set-up of the batcher's path
    print(f"warming up the batch-{opt.max_batch} serving program ...", flush=True)
    try:
        engine.submit(np.full((opt.imgsz, opt.imgsz, 3), 114, np.uint8)).result()
        server = make_server(engine, tasks, host=opt.host, port=opt.port)
    except BaseException:
        engine.stop()
        raise
    return inference, engine, server


def main(argv=None):
    opt = parse_opt(argv)
    _, engine, server = build(opt)
    host, port = server.server_address[:2]
    print(f"serving {list(engine.inference.names)} on {host}:{port} "
          f"(batch {opt.max_batch}, wait {opt.max_wait_ms}ms, int8={opt.int8})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()
        server.server_close()


if __name__ == "__main__":
    main()
