"""The flagship at full width: the port's predict on 2-task CerberusDet-v8x
(configs/models/yolov8x_2task.yaml, nc 20/19) at 640 px against the JAX
package's, both in float64 (JAX under enable_x64) on the same bridged
parameters and frame; the counterpart of tests/test_golden_640.py's float64
parity, which needs the reference's own model.

A random-init v8x at 640 px amplifies a difference by ~1.7e5, so only
float64 on both sides says anything: the result lists must be identical
(same length, order, task, label, label_name; boxes within 1 px), as
tests/test_torch_inference.py holds yolov8n, and the scores within 2
float32 ulps (rtol 2.4e-7): both packages decode in float32
(cerberusdet_tpu/nn/layers.py:448-450), where XLA's sigmoid on the CPU and
PyTorch's may round a score differently (seen: 1 ulp, 3.7e-9 at 0.039). The
port's model is float64 before the weights load, so that it folds the
BatchNorms in float64 as JAX does (a float32 fold moved scores by 2e-6). The seeded model takes its
BatchNorm statistics from a seeded frame (testing.calibrate_bn), so that
its scores depend on the image, and its box biases are re-drawn from a seed
(with the prior bias every anchor draws the same box). Marked slow: about
four minutes on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu_torch.infer import CerberusDetInference
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import calibrate_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "models", "yolov8x_2task.yaml")
TASKS, NCS = ["voc", "animals"], [20, 19]
NAMES = {t: [f"{t}_{i}" for i in range(n)] for t, n in zip(TASKS, NCS)}


@pytest.mark.slow
def test_flagship_640_predict_float64_matches_jax():
    rng = np.random.default_rng(0)
    model = CerberusModel(FLAGSHIP, TASKS, NCS, device="cpu").init(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in TASKS:
            head = model.block(model.head_uid(t))
            for i in range(head.nl):
                b = getattr(head, f"box{i}")[2].b
                b.copy_(torch.randn(b.shape, generator=gen) * 3.0)
    calibrate_bn(model, torch.from_numpy(rng.uniform(0, 1, (1, 3, 640, 640)).astype(np.float32)))
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float64), export_jax_params(model))
    x = rng.uniform(0, 1, (1, 640, 640, 3))
    shape = [(480, 640)]

    with jax.enable_x64():
        ref = JaxInference(model=JaxModel(FLAGSHIP, TASKS, NCS),
                           params=jax.tree_util.tree_map(jnp.asarray, params), names=NAMES,
                           conf_thres=1e-3, img_size=640, half=False, dtype=jnp.float64)
        want = ref.predict(x, original_shape=shape)
    # a float64 model before the load, so that the BatchNorm fold runs in float64 as JAX's
    f64 = CerberusModel(FLAGSHIP, TASKS, NCS, device="cpu").to(torch.float64)
    ours = CerberusDetInference(model=f64, params=params, names=NAMES, conf_thres=1e-3, img_size=640,
                                dtype=torch.float64, device="cpu")
    got = ours.predict(x, original_shape=shape)
    assert len(got) == len(want) == 1 and len(got[0]) == len(want[0])
    for o, r in zip(got[0], want[0]):
        assert (o["task"], o["label"], o["label_name"]) == \
            (r["task"], r["label"], r["label_name"]), (o, r)
        np.testing.assert_allclose(o["score"], r["score"], rtol=2.4e-7)
        assert max(abs(a - b) for a, b in zip(o["box"], r["box"])) <= 1, (o, r)
    assert {d["task"] for d in got[0]} == set(TASKS)
