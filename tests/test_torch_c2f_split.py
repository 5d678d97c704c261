"""tools/bench_c2f_split.py on the CPU at yolov8n_2task, 64 px, through the
kernels' plain versions: the int8 split (per-chunk quant_pack_s8 + conv_s8
in int32 mode, summed, conv_epilogue) equals the concat route bit for bit,
and the float32 split is within 1e-4; the split's conv_s8 launches are the
concat forward's plus 1 + n per C2f; the tool's main prints JAX's JSON."""

import json
import os

import pytest
import torch

from cerberusdet_tpu_torch.nn.layers import C2f
from cerberusdet_tpu_torch.ops import conv_int8_cuda
from cerberusdet_tpu_torch.tools import bench_c2f_split as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
CPU = ["--device", "cpu", "--cfg", SMALL, "--nc", "3,5", "--imgsz", "64", "--batch", "2",
       "--iters", "1"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("int8", [False, True])
def test_split_equals_concat(int8):
    model = tool.build(SMALL, [3, 5], torch.device("cpu"), int8, imgsz=64)
    err = tool.check_equal(model, int8, imgsz=96)
    assert err == 0.0 if int8 else err < 1e-4
    blocks = [m for m in model.modules() if isinstance(m, C2f)]
    assert blocks and all(m.cv2.int8 == int8 for m in blocks)
    img = tool.make_input(2, 64, torch.device("cpu"))
    if int8:
        # every chunk launches conv_s8 once (the plain version here, counted
        # by the wrapper only on the card): count the calls instead
        calls = []
        real = tool.conv_s8

        def counting(*a, **k):
            calls.append(k.get("out_dtype"))
            return real(*a, **k)

        tool.conv_s8 = counting
        try:
            with tool.split_c2f(model), torch.no_grad():
                tool.forward_fn(model)(img)
        finally:
            tool.conv_s8 = real
        assert calls == [torch.int32] * sum(2 + len(m.m) for m in blocks)
    n_convs, n_int8 = tool.split_convs(model)
    base = tool.model_convs(model)
    assert n_convs - base[0] == sum(1 + len(m.m) for m in blocks)
    assert n_int8 - base[1] == (n_convs - base[0]) * int8
    assert tool.C2f.forward.__qualname__ == "C2f.forward"  # the split is undone


def test_split_refuses_an_unfused_block():
    from cerberusdet_tpu_torch.models.cerberus import CerberusModel

    model = CerberusModel(SMALL, ["a", "b"], [3, 5], device="cpu").init(0)
    block = next(m for m in model.modules() if isinstance(m, C2f))
    with pytest.raises(ValueError, match="fused"):
        tool.chunk_weights(block)


@pytest.mark.parametrize("int8", [False, True])
def test_main_prints_jax_json(capsys, int8):
    out = tool.main(CPU + (["--int8"] if int8 else []))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    tag = "_int8" if int8 else ""
    assert set(out) == {f"baseline_concat{tag}", f"c2f_sumsplit{tag}", "card"}
    for k, r in out.items():
        if k != "card":
            assert set(r) == {"ms_per_batch", "img_per_s"} and r["img_per_s"] > 0
    assert conv_int8_cuda.conv_s8.launches == 0  # no kernel on the CPU
