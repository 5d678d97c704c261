"""The port's serving path as a whole against the JAX package's.

CerberusDetInference.predict of cerberusdet_tpu_torch against
cerberusdet_tpu's on yolov8n_2task at 64 px, in float64 on both sides (JAX
under enable_x64, as tests/test_golden_640.py runs it): the result lists must
be identical — same length, task, label, label_name; score rtol 1e-9; boxes
within 1 px. Both decode and NMS in float32 (nn/layers.py Detect.decode), so
the scores are the same float32 values."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.infer.preprocessor import CerberusPreprocessor as JaxPreprocessor
from cerberusdet_tpu.manager.checkpoint import save_checkpoint
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu_torch.infer import CerberusDetInference, CerberusPreprocessor
from cerberusdet_tpu_torch.models.cerberus import CerberusModel

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]
NAMES = {"a": ["c0", "c1", "c2"], "b": ["k0", "k1", "k2", "k3", "k4"]}
SHAPES = [(96, 128), (64, 64), (50, 80), (128, 96)]


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for ro, rr in zip(ours, ref):
        assert len(ro) == len(rr)
        for o, r in zip(ro, rr):
            assert (o["task"], o["label"], o["label_name"]) == \
                (r["task"], r["label"], r["label_name"]), (o, r)
            np.testing.assert_allclose(o["score"], r["score"], rtol=1e-9)
            assert max(abs(a - b) for a, b in zip(o["box"], r["box"])) <= 1, (o, r)


def _distinct_heads(params, seed):
    """Random box-tower biases. With the prior bias (all bins 1.0) a
    random-init model draws the same box at every anchor in every task, and
    cross-task suppression then leaves one task only."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for t in TASKS:
        for i in range(3):
            last = params[f"head_{t}"][f"box{i}"]["2"]
            last["b"] = rng.normal(0, 3, last["b"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def f64_pair():
    """(jax params tree as numpy float64, JAX f64 results, input batch)."""
    x = np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3))
    model = JaxModel(CFG, TASKS, NCS)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            _distinct_heads(model.init(jax.random.PRNGKey(0)), seed=1))
        ref = JaxInference(model=model, params=params, names=NAMES, conf_thres=1e-4,
                           img_size=64, half=False, dtype=jnp.float64)
        dets = ref.predict(x, original_shape=SHAPES)
    return jax.tree_util.tree_map(np.asarray, params), dets, x


def test_predict_float64_matches_jax(f64_pair):
    params, ref, x = f64_pair
    model = CerberusModel(CFG, TASKS, NCS, device="cpu")
    ours = CerberusDetInference(model=model, params=params, names=NAMES, conf_thres=1e-4,
                                img_size=64, dtype=torch.float64, device="cpu")
    dets = ours.predict(x, original_shape=SHAPES)
    _assert_same(dets, ref)
    for task in TASKS:  # both tasks really detect something
        assert sum(d["task"] == task for r in dets for d in r) > 0


def test_predict_from_checkpoint(tmp_path, f64_pair):
    """weights=: the .ckpt.npz route gives the same results as (model, params)."""
    params, _, x = f64_pair
    params32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    path = tmp_path / "w.ckpt.npz"
    save_checkpoint(path, params32, {"cfg": CFG, "task_ids": TASKS, "nc": NCS,
                                     "names": [NAMES[t] for t in TASKS]}, half=False)
    common = dict(conf_thres=1e-3, img_size=64, dtype=torch.float32, device="cpu")
    a = CerberusDetInference(weights=str(path), **common).predict(x, SHAPES)
    b = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                             params=params32, names=NAMES, **common).predict(x, SHAPES)
    assert a == b and sum(map(len, a)) > 0


def test_seeded_model_predicts_on_cpu():
    """params=None serves the model's own (seeded) weights; contract checks."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    inf = CerberusDetInference(model=model, names=NAMES, conf_thres=1e-4, img_size=64,
                               dtype=torch.float32, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = inf.predict(x, original_shape=[(320, 240), (100, 100)])
    assert len(out) == 2 and sum(map(len, out)) > 0
    for image_results, (h, w) in zip(out, [(320, 240), (100, 100)]):
        scores = [d["score"] for d in image_results]
        assert scores == sorted(scores, reverse=True)
        for d in image_results:
            assert set(d) == {"box", "score", "label", "label_name", "task"}
            assert d["label_name"] == (NAMES["a"] + NAMES["b"])[d["label"]]
            x1, y1, x2, y2 = d["box"]
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h


@pytest.mark.parametrize("shape", [(240, 320), (100, 50), (37, 90), (64, 64)])
def test_device_preprocessor_matches_jax(shape):
    """Device letterbox: F.interpolate(bilinear, antialias) against
    jax.image.resize("linear"), which antialiases when it shrinks. Measured
    agreement is float32 rounding (<= 3e-7 on [0, 1]); the bound is 1e-6."""
    imgs = np.random.default_rng(0).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    ref, ref_shapes = JaxPreprocessor(img_size=64).preprocess_device(imgs)
    ours, shapes = CerberusPreprocessor(img_size=64, device="cpu").preprocess(list(imgs))
    assert shapes == ref_shapes
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_host_preprocessor_matches_jax():
    """Ragged inputs take the cv2 host path: bit-identical."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8) for s in [(240, 320, 3), (100, 50, 3)]]
    ref, ref_shapes = JaxPreprocessor(img_size=64).preprocess(imgs)
    ours, shapes = CerberusPreprocessor(img_size=64, device="cpu").preprocess(imgs)
    assert shapes == ref_shapes
    np.testing.assert_array_equal(ours, np.asarray(ref))


def test_default_device_is_the_card():
    """Entry points default to the card and raise when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CerberusModel(CFG, TASKS, NCS)
    with pytest.raises(RuntimeError, match="CUDA"):
        CerberusPreprocessor(img_size=64)
    model = CerberusModel(CFG, TASKS, NCS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        CerberusDetInference(model=model, names=NAMES)


@pytest.mark.parametrize("half", [False, None])
def test_half_matches_jax(half):
    """half=False computes in float32 and the default (half=True) in
    bfloat16, in both packages; both built with warmup_batch=2. The results
    equal JAX's on the same float32 weights."""
    kw = {} if half is None else {"half": half}
    model = JaxModel(CFG, TASKS, NCS)
    params = jax.tree_util.tree_map(
        np.asarray, _distinct_heads(model.init(jax.random.PRNGKey(0)), seed=1))
    common = dict(params=params, names=NAMES, conf_thres=1e-4, img_size=64, warmup_batch=2,
                  **kw)
    ref = JaxInference(model=model, **common)
    ours = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                device="cpu", **common)
    want = torch.float32 if half is False else torch.bfloat16
    assert ours.dtype == want and ref.compute_dtype == (jnp.float32 if half is False
                                                        else jnp.bfloat16)
    x = np.random.default_rng(3).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    dets = ours.predict(x, original_shape=SHAPES)
    _assert_same(dets, ref.predict(x, original_shape=SHAPES))
    assert sum(map(len, dets)) > 0


def test_dtype_overrides_half_and_warmup_batch_predicts_once(monkeypatch):
    """dtype wins over half; warmup_batch=n runs one predict on zeros of
    (n, img_size, img_size, 3) at construction, and None runs none."""
    calls = []
    real = CerberusDetInference.predict
    monkeypatch.setattr(CerberusDetInference, "predict",
                        lambda self, batch, *a, **k: calls.append(np.shape(batch))
                        or real(self, batch, *a, **k))
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    inf = CerberusDetInference(model=model, names=NAMES, img_size=64, half=True,
                               dtype=torch.float32, device="cpu")
    assert inf.dtype == torch.float32 and calls == []
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    inf = CerberusDetInference(model=model, names=NAMES, img_size=64, half=False,
                               dtype=torch.float64, device="cpu", warmup_batch=3)
    assert inf.dtype == torch.float64 and calls == [(3, 64, 64, 3)]


def _route_log(pre, log):
    """Record on `log` which of pre's two paths each preprocess call takes."""
    for name in ("preprocess_device", "preprocess_host"):
        real = getattr(pre, name)
        setattr(pre, name, lambda *a, real=real, name=name: log.append(name) or real(*a))


def test_preprocessor_routes_as_jax():
    """Device or host, call by call, in both packages: 5 distinct uniform
    source shapes (the fifth beyond MAX_DEVICE_SHAPES goes to the host), a
    repeat of the first (cached: device), a ragged list (host), and
    auto=True and prefer_device=False preprocessors (host)."""
    from cerberusdet_tpu.infer.preprocessor import MAX_DEVICE_SHAPES as JAX_MAX
    from cerberusdet_tpu_torch.infer.preprocessor import MAX_DEVICE_SHAPES

    assert MAX_DEVICE_SHAPES == JAX_MAX == 4
    rng = np.random.default_rng(4)

    def frames(*shapes):
        return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]

    calls = [frames(s, s) for s in [(40, 50), (64, 64), (30, 90), (70, 20), (33, 33)]]
    calls += [frames((40, 50), (40, 50)), frames((40, 50), (64, 64))]
    routes = {}
    for label, (ours, ref) in {
        "default": (CerberusPreprocessor(img_size=64, device="cpu"),
                    JaxPreprocessor(img_size=64)),
        "auto": (CerberusPreprocessor(img_size=64, device="cpu", auto=True),
                 JaxPreprocessor(img_size=64, auto=True)),
        "prefer_device=False": (CerberusPreprocessor(img_size=64, device="cpu",
                                                     prefer_device=False),
                                JaxPreprocessor(img_size=64, prefer_device=False)),
    }.items():
        logs = ([], [])
        _route_log(ours, logs[0])
        _route_log(ref, logs[1])
        for imgs in calls if label == "default" else calls[:1]:
            _, shapes = ours.preprocess(imgs)
            _, ref_shapes = ref.preprocess(imgs)
            assert shapes == ref_shapes
        assert logs[0] == logs[1], label
        assert len(ours._device_fns) <= MAX_DEVICE_SHAPES
        routes[label] = logs[0]
    dev, host = "preprocess_device", "preprocess_host"
    assert routes == {"default": [dev] * 4 + [host, dev, host], "auto": [host],
                      "prefer_device=False": [host]}


def _small_inference(**kw):
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    kw = {"dtype": torch.float32, **kw}
    return CerberusDetInference(model=model, names=NAMES, conf_thres=1e-4, img_size=64,
                                device="cpu", **kw)


def test_program_key_follows_jax_static_arguments():
    """predict's program key changes with the batch's shape or dtype, the
    compute dtype, the int8 mode and each of JAX's static arguments, and
    is the same for the same request."""
    inf = _small_inference()
    batch = torch.zeros((2, 64, 64, 3))
    args = (0.25, 0.45, 0.8, False, 300)
    key = inf.program_key(batch, *args)
    assert key == inf.program_key(torch.ones((2, 64, 64, 3)), *args)
    others = [inf.program_key(torch.zeros((1, 64, 64, 3)), *args),
              inf.program_key(torch.zeros((2, 64, 96, 3)), *args),
              inf.program_key(batch.double(), *args),
              _small_inference(dtype=torch.bfloat16).program_key(batch, *args),
              _small_inference(int8="all").program_key(batch, *args)]
    for i in range(len(args)):
        changed = list(args)
        changed[i] = (not changed[i]) if isinstance(changed[i], bool) else changed[i] / 2
        others.append(inf.program_key(batch, *changed))
    assert len({key, *others}) == len(others) + 1


def test_cpu_predict_never_touches_the_card(monkeypatch):
    """On the CPU predict runs eagerly: no capture, no stream, no CUDA call."""
    inf = _small_inference(warmup_batch=1)

    def refuse(*a, **k):
        raise AssertionError("torch.cuda was called on the CPU path")

    for name in ("_lazy_init", "CUDAGraph", "graph", "graph_pool_handle", "Stream", "stream",
                 "current_stream", "synchronize", "is_available", "device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = inf.predict(x, original_shape=[(64, 64)] * 2)
    assert sum(map(len, out)) > 0 and inf.programs == {}
    pre = CerberusPreprocessor(img_size=64, device="cpu")
    batch, _ = pre.preprocess([np.zeros((40, 50, 3), np.uint8)] * 2)
    assert batch.device.type == "cpu" and pre._programs == {}


@pytest.mark.cuda
def test_replayed_predict_matches_eager_on_card():
    """On the card: predict replays one captured graph per key, and its
    result equals predict_device run eagerly, bit for bit, for the
    capturing request, a later one with other frames, and after an in-place
    weight update; a new threshold captures a new key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cerberusdet_tpu_torch.infer.inference import pack_outputs

    model = CerberusModel(CFG, TASKS, NCS, device="cuda").init(0)
    inf = CerberusDetInference(model=model, names=NAMES, conf_thres=1e-4, img_size=64,
                               device="cuda")
    rng = np.random.default_rng(0)
    args = (1e-4, 0.45, 0.8, False, 300)

    def check(x):
        xb = torch.from_numpy(x).cuda()
        inf.predict(x)
        prog = inf.programs[inf.program_key(xb, *args)]
        replayed = prog.run(xb).clone()
        assert torch.equal(replayed, pack_outputs(*inf.predict_device(xb, *args)))

    for _ in range(2):
        check(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    assert len(inf.programs) == 1
    with torch.no_grad():
        inf.model.block(inf.model.head_uid("a")).cls0[2].b.add_(0.5)
    check(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    inf.predict(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32), iou_thres=0.5)
    assert len(inf.programs) == 2
