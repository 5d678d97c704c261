"""Training BatchNorm with its SiLU as one Function (ops/bn_cuda.py) and its
dispatch in nn/module.py:BatchNorm.

On the CPU: the Function, run by its plain passes, against autograd through
the port's BatchNorm followed by SiLU in float32 (forward, running
statistics, dx, dweight and dbias, with and without SiLU, one channel cut
into chunks of which the last is short); the chunking of the v8x train
shapes; which forwards take the Function (the route counters, with the card
stubbed by `bn_cuda.on_card`). The tests marked `cuda` hold the kernels
(csrc/bn_silu.cu) against the plain passes at the v8x train shapes on the
card: the forward's y bit for bit given the kernels' statistics, the
statistics and gradients within stated tolerances, two runs bit for bit, a
CUDA-graph replay equal to the eager call, the launch counts, and the
routes of a training forward. Run them there with
`python -m pytest -m cuda --noconftest tests/test_torch_bn_silu.py`.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.nn import module
from cerberusdet_tpu_torch.nn.layers import Conv
from cerberusdet_tpu_torch.nn.module import BN_MOMENTUM, BatchNorm
from cerberusdet_tpu_torch.ops import bn_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")

# (N, C, H, W): one chunk of planes of no whole 16-byte vector; one chunk;
# two chunks, the second short (N * H * W = 17654, chunks of 8832)
CPU_SHAPES = [(2, 3, 5, 7), (4, 16, 32, 32), (2, 4, 91, 97)]
# the channels and maps of the v8x train step's BatchNorms at 640 px
V8X_SHAPES = [(80, 320, 320), (160, 160, 160), (320, 80, 80), (640, 40, 40), (640, 20, 20)]


def _bn(c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_mean.copy_(torch.rand(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn


def _inputs(shape, seed=0, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    # per-channel offsets and scales, as a conv's output has
    c = shape[1]
    x = (torch.randn(shape, generator=gen) * (torch.rand(c, generator=gen) * 3 + 0.1)[:, None, None]
         + torch.randn(c, generator=gen)[:, None, None] * 2)
    dy = torch.randn(shape, generator=gen)
    return x.to(device=device, dtype=dtype), dy.to(device=device, dtype=dtype)


def _fused(bn, x, dy, act):
    """bn_silu's y, the running statistics it leaves and its gradients."""
    x = x.detach().clone().requires_grad_()
    w, b = bn.weight.detach().clone().requires_grad_(), bn.bias.detach().clone().requires_grad_()
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y = bn_cuda.bn_silu(x, w, b, rm, rv, bn.eps, BN_MOMENTUM, act)
    y.backward(dy)
    return y.detach(), rm, rv, x.grad, w.grad, b.grad


def _port(bn, x, dy, act):
    """The same through the port's BatchNorm (its PyTorch path) and SiLU."""
    x = x.detach().clone().requires_grad_()
    y = bn(x)
    y = F.silu(y) if act else y
    y.backward(dy)
    return y.detach(), bn.running_mean, bn.running_var, x.grad, bn.weight.grad, bn.bias.grad


def _close(a, b, rtol, what):
    """|a - b| <= rtol * max |b|, elementwise."""
    a, b = a.detach().float(), b.detach().float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    assert err <= rtol * scale, f"{what}: max error {err} against scale {scale}"


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize("rows", [0, 1])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_plain_function_matches_batchnorm_and_silu(shape, act, rows):
    """float32, NCHW and channels last: the Function's plain passes against
    autograd through the port's BatchNorm + SiLU. Both sum in float32 in
    other orders (chunks merged by Chan's formula against torch's sums), so
    each result is held to 1e-5 of its largest magnitude."""
    x, dy = _inputs(shape)
    if rows:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    got = _fused(_bn(shape[1]), x, dy, act)
    bn = _bn(shape[1])
    bn.train()
    want = _port(bn, x, dy, act)
    for name, a, b in zip(("y", "running_mean", "running_var", "dx", "dweight", "dbias"),
                          got, want):
        _close(a, b, 1e-5, name)


def test_chunking_fills_the_card_at_the_v8x_shapes():
    """At the train cell's 16 images a task, both layouts: chunks that cover
    each channel once (planar ones whole vectors long), about two waves of blocks wherever
    the values allow, and no block under MIN_CHUNK values unless a channel (or a
    rows tile) holds fewer."""
    for c, h, w in V8X_SHAPES + [(3, 5, 7), (4, 91, 97)]:
        nhw = 16 * h * w
        for units, width in ((c, 1), (1, c)):  # planar; rows, one tile
            length, chunks = bn_cuda.chunking(units, nhw, width)
            assert width > 1 or length % bn_cuda.ALIGN == 0
            assert (chunks - 1) * length < nhw <= chunks * length
            # lengths rounded up to whole vectors may cost a few chunks
            want = min(bn_cuda.SLOTS_PER_SM * 132, nhw * width // bn_cuda.MIN_CHUNK)
            assert units * chunks >= 0.9 * want
            assert length * width >= bn_cuda.MIN_CHUNK // 2 or chunks == 1
    assert bn_cuda.chunking(80, 16 * 320 * 320) == (60688, 27)
    assert bn_cuda.chunking(1, 16 * 320 * 320, 80) == (776, 2112)
    assert bn_cuda.chunking(1, 16 * 80 * 80, 320) == (49, 2090)
    assert bn_cuda.chunking(640, 16 * 20 * 20) == (6400, 1)


def test_layouts_and_plans():
    """The layout families the kernels walk: NCHW planes and channels last,
    each with channel slices; 16-byte vectors only where every value lies in
    an aligned vector; anything else in neither family (made dense first). A
    backward reads dy in x's family, or in NCHW planes against channels last
    (value by value); other pairs take a copy of dy in x's family."""
    x = torch.zeros((2, 48, 10, 12), dtype=torch.bfloat16)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert bn_cuda.strides(x) == (0, (5760, 120, 1))
    assert bn_cuda.strides(cl) == (1, (5760, 1, 48))
    assert bn_cuda.strides(cl[:, 8:24]) == (1, (5760, 1, 48))
    assert bn_cuda.strides(x[:, 8:24]) == (0, (5760, 120, 1))
    assert bn_cuda.strides(x.transpose(2, 3)) is None
    assert bn_cuda.grad_layout(x.transpose(2, 3), 1).is_contiguous(
        memory_format=torch.channels_last)
    assert bn_cuda.grad_layout(x, 1) is x          # NCHW planes against a rows x: read as they are
    assert bn_cuda.grad_layout(cl, 0).is_contiguous()  # rows against planes: made NCHW
    assert bn_cuda.plan(x).rows == 0 and bn_cuda.plan(x).vec == 1
    assert bn_cuda.plan(cl).rows == 1 and bn_cuda.plan(cl).vec == 1
    assert bn_cuda.plan(cl[:, 8:24]).vec == 1
    assert bn_cuda.plan(cl[:, 4:20]).vec == 0       # 4 channels in: not 16-byte aligned
    assert bn_cuda.plan(x[:, :, :9]).rows == 0 and bn_cuda.plan(x[:, :, :9]).vec == 0
    assert bn_cuda.plan(x.float()).vec == 1
    assert bn_cuda.plan(cl, x) == bn_cuda.plan(cl)._replace(dy_planes=1)
    odd = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)  # planes, 2 B off
    assert bn_cuda.plan(cl, odd).vec == 1           # planes against rows: read value by value


def _routes():
    return bn_cuda.FUSED.launches, bn_cuda.PLAIN.launches


def test_dispatch_by_route(monkeypatch):
    """Only a training, unfrozen BatchNorm without an image mask, and without
    a process group or with a group of one rank, on the card in float32 or
    bfloat16, takes the Function; a group of several ranks, a mask or
    float64 takes the PyTorch path; another dtype raises. The card is stubbed
    (`on_card`), so the Function runs its plain passes."""
    x, _ = _inputs((2, 4, 6, 6))
    bn = _bn(4).train()
    before = _routes()
    ref = bn(x, True)  # the CPU: the PyTorch path, no route counted
    assert _routes() == before

    monkeypatch.setattr(bn_cuda, "on_card", lambda t: True)
    calls = []
    real = bn_cuda.bn_silu
    monkeypatch.setattr(bn_cuda, "bn_silu", lambda *a: calls.append(a[-1]) or real(*a))
    bn = _bn(4).train()
    y = bn(x, True)
    assert calls == [True] and _routes() == (before[0] + 1, before[1])
    _close(y, ref, 1e-5, "fused y")

    bn.eval()  # eval: the running statistics, no route
    bn(x, True)
    bn.train()
    bn.frozen = True
    bn(x, False)
    bn.frozen = False
    assert len(calls) == 1 and _routes() == (before[0] + 1, before[1])

    bn.img_mask = torch.ones(2)
    bn(x, True)
    bn.img_mask = None
    ranks = {"one": 1, "two": 2}
    monkeypatch.setattr(module, "all_reduce_sum", lambda t, group: t)
    monkeypatch.setattr(module, "group_size", lambda group: 1 if group is None else ranks[group])
    bn.group = "one"  # a group of one rank: the group-less arithmetic, the Function
    _close(bn(x, True), ref, 1e-5, "a group of one's y")
    assert calls == [True, True] and _routes() == (before[0] + 2, before[1] + 1)
    bn.group = "two"
    bn(x, True)
    bn.group = None
    b64 = _bn(4).double().train()  # float64: the reference runs keep the PyTorch path
    b64(x.double(), True)
    assert len(calls) == 2 and _routes() == (before[0] + 2, before[1] + 3)
    for dtype in (torch.float16, torch.float64):  # x half, or float64 with float32 weights
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            (bn if dtype == torch.float16 else _bn(4).train())(x.to(torch.float16), True)
    assert _routes() == (before[0] + 2, before[1] + 3)


def test_mesh_route_against_the_kernels_route(monkeypatch):
    """The arithmetic the one-card route and the mesh's route no longer
    share, in bfloat16 (the train step's dtype) with SiLU, both layouts: the
    Function (the card stubbed, so its plain passes, which the kernels
    follow) against the PyTorch path that a mask of all ones takes, the
    mesh's path on one rank's rows. y is the same (the statistics differ in
    float32 only); the running statistics within 1e-6 of their largest; the
    gradients differ by the PyTorch path's bfloat16 roundings in autograd's
    chain: dx within 2^-6, dweight within 0.06 and dbias within 0.01 of
    their largest (up to 0.0060, 0.0264 and 0.0030 measured). The
    Function's dweight and dbias lie nearer a float64 computation of the
    same function than the PyTorch path's."""
    monkeypatch.setattr(bn_cuda, "on_card", lambda t: True)
    for shape in ((4, 16, 24, 24), (2, 4, 91, 97), (8, 32, 40, 40)):
        for rows in (0, 1):
            x, dy = _inputs(shape, dtype=torch.bfloat16)
            if rows:
                x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
            routes = _routes()
            got = _fused(_bn(shape[1]), x, dy, True)
            mesh = _bn(shape[1]).train()
            mesh.img_mask = torch.ones(shape[0])
            want = _port(mesh, x, dy, True)
            assert _routes() == (routes[0], routes[1] + 1)  # the mask: the PyTorch path
            exact = _port(_bn(shape[1]).double().train(), x.double(), dy.double(), True)
            what = f"{shape} {'rows' if rows else 'planes'}"
            assert torch.equal(got[0], want[0]), f"{what}: y"
            for i, name, rtol in ((1, "running_mean", 1e-6), (2, "running_var", 1e-6),
                                  (3, "dx", 2.0 ** -6), (4, "dweight", 0.06), (5, "dbias", 0.01)):
                _close(got[i], want[i], rtol, f"{what}: {name}")
            for i, name in ((4, "dweight"), (5, "dbias")):
                err = [float((r[i].double() - exact[i]).abs().max()) for r in (got, want)]
                assert err[0] <= err[1], f"{what}: {name} off float64 by {err}"


def test_conv_hands_its_act_to_the_batchnorm(monkeypatch):
    """A Conv's BatchNorm and SiLU are one call: with the card stubbed, a
    training forward of a 2-task model takes the Function once for every
    BatchNorm forward and the plain path never, and gives the plain path's
    outputs."""
    model = CerberusModel(CFG, ["a", "b"], [3, 5], device="cpu").init(0).train()
    x, _ = _inputs((2, 3, 64, 64), seed=1)
    want = model(x)
    forwards = []
    hooks = [m.register_forward_hook(lambda m, i, o: forwards.append(m))
             for m in model.modules() if isinstance(m, BatchNorm)]
    acts = []
    real = bn_cuda.bn_silu
    monkeypatch.setattr(bn_cuda, "on_card", lambda t: True)
    monkeypatch.setattr(bn_cuda, "bn_silu", lambda *a: acts.append(a[-1]) or real(*a))
    before = _routes()
    got = model(x)
    for h in hooks:
        h.remove()
    assert len(acts) == len(forwards) > 0
    assert _routes() == (before[0] + len(forwards), before[1])
    convs = {m.bn: m.act for m in model.modules() if isinstance(m, Conv) and hasattr(m, "bn")}
    assert acts == [convs[m] for m in forwards]
    for t in want:
        for a, b in zip(got[t], want[t]):
            _close(a, b, 1e-4, f"task {t}")


# ------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    return [w.launches for w in (bn_cuda.bn_stats, bn_cuda.bn_apply, bn_cuda.bn_grad_reduce,
                                 bn_cuda.bn_dx)]


def _layout(t, rows):
    return t.contiguous(memory_format=torch.channels_last) if rows else t.contiguous()


def _kernel_run(x, dy, act, seed=0):
    """The kernels on the card, each pass's outputs kept apart."""
    bn = _bn(x.shape[1], seed)
    w, b = bn.weight.detach().to(x.device), bn.bias.detach().to(x.device)
    rm, rv = bn.running_mean.to(x.device), bn.running_var.to(x.device)
    p, pg = bn_cuda.plan(x), bn_cuda.plan(x, dy)
    stat, part = bn_cuda.bn_stats(x, w, b, rm, rv, bn.eps, BN_MOMENTUM, p)
    y = bn_cuda.bn_apply(x, stat, act, p)
    coef, dw, db, gpart = bn_cuda.bn_grad_reduce(dy, x, stat, act, pg)
    dx = bn_cuda.bn_dx(dy, x, stat, coef, act, pg)
    return dict(part=part, y=y, stat=stat, rm=rm, rv=rv, gpart=gpart, coef=coef, dx=dx, dw=dw,
                db=db, plan=p, gplan=pg, bn=bn)


def _check_against_plain(k, x, dy, act):
    """The kernels' outputs k against the plain passes on the CPU:
    * y equals PyTorch's BatchNorm arithmetic + silu on the card bit for bit,
      given the kernels' own stat, and keeps x's layout family;
    * the chunks' means within 1e-5 and M2 within 1e-4 of the largest; the
      merged stat and the running statistics within 1e-5 (float32 sums in
      other orders);
    * from the same stat, dweight and dbias within 1e-4 of the largest; dx
      within one rounding of the activation dtype (2^-7 relative for
      bfloat16) plus 1e-5 of the largest."""
    rows = bn_cuda.strides(x)[0]
    mean, rstd, inv, shift = k["stat"]
    z = x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    assert torch.equal(k["y"], F.silu(z) if act else z)
    fmt = torch.channels_last if rows else torch.contiguous_format
    assert k["y"].is_contiguous(memory_format=fmt) and k["dx"].is_contiguous(memory_format=fmt)

    xc, dyc, p = x.cpu(), dy.cpu(), k["plan"]
    bn = k["bn"]
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    stat, part = bn_cuda.bn_stats_plain(xc, bn.weight.detach(), bn.bias.detach(), rm, rv, bn.eps,
                                        BN_MOMENTUM, p.length, p.chunks)
    _close(k["part"][..., 0].cpu(), part[..., 0], 1e-5, "chunk means")
    _close(k["part"][..., 1].cpu(), part[..., 1], 1e-4, "chunk M2")
    for i, name in enumerate(("mean", "rstd", "inv", "shift")):
        _close(k["stat"][i].cpu(), stat[i], 1e-5, name)
    _close(k["rm"].cpu(), rm, 1e-5, "running_mean")
    _close(k["rv"].cpu(), rv, 1e-5, "running_var")

    kstat, pg = k["stat"].cpu(), k["gplan"]
    coef, dw, db, _ = bn_cuda.bn_grad_reduce_plain(dyc, xc, kstat, act, pg.length, pg.chunks)
    _close(k["dw"].cpu(), dw, 1e-4, "dweight")
    _close(k["db"].cpu(), db, 1e-4, "dbias")
    dx = bn_cuda.bn_dx_plain(dyc, xc, kstat, coef, act).float()
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -20
    err = (k["dx"].cpu().float() - dx).abs()
    assert bool((err <= ulp * dx.abs() + 1e-5 * float(dx.abs().max())).all()), "dx"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 0])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chw", V8X_SHAPES)
def test_kernels_match_plain_at_v8x_shapes(chw, dtype, act, rows):
    """Two images at each v8x train shape, channels last (the train step's
    layout) and NCHW: the kernels against the plain passes
    (_check_against_plain), each launched once (bn_stats and bn_grad_reduce
    two kernels each), and a second run bit for bit the first."""
    dev = _card()
    x, dy = (_layout(t, rows) for t in _inputs((2,) + chw, dtype=dtype, device=dev))
    before = _launches()
    k = _kernel_run(x, dy, act)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [2, 1, 2, 1]
    assert k["plan"].rows == rows and k["plan"].vec == 1
    _check_against_plain(k, x, dy, act)
    again = _kernel_run(x, dy, act)
    for name in ("part", "y", "stat", "rm", "rv", "gpart", "coef", "dx", "dw", "db"):
        assert torch.equal(again[name], k[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_other_routes_and_strided_dy(dtype):
    """Planes or rows of no whole vector (15 x 17 planes; 18 channels) take
    the kernels' one-value route, and 2304 channels take two rows tiles,
    each against the plain passes; dy as a channel slice of a wider tensor
    (a concat's gradient), in x's family or in NCHW planes against channels
    last, gives the dense dy's results bit for bit."""
    dev = _card()
    for shape, rows, vec in (((3, 24, 15, 17), 0, 0), ((3, 18, 16, 16), 1, 0),
                             ((2, 2304, 4, 6), 1, 1)):
        x, dy = (_layout(t, rows) for t in _inputs(shape, dtype=dtype, device=dev))
        k = _kernel_run(x, dy, True)
        assert k["plan"].vec == vec
        _check_against_plain(k, x, dy, True)
    for rows, dy_rows in ((0, 0), (1, 1), (1, 0)):
        x, dy = (_layout(t, rows) for t in _inputs((2, 64, 40, 40), dtype=dtype, device=dev))
        wide = _layout(torch.zeros((2, 96, 40, 40), dtype=dtype, device=dev), dy_rows)
        wide[:, 16:80] = dy
        a, b = _kernel_run(x, dy, True), _kernel_run(x, wide[:, 16:80], True)
        assert b["gplan"].vec == 1 and b["gplan"].dy_planes == int(rows != dy_rows)
        for name in ("gpart", "coef", "dx", "dw", "db"):
            assert torch.equal(a[name], b[name]), name


GUARD = 4096  # values around every tensor of the guard test


def _guarded(shape, dtype, rows, dev, fill, channels=None, first=0):
    """(view, buffer): a tensor of `shape` in family `rows`, the channels
    [first, first + C) of a wider one of `channels` channels, which lies
    GUARD values into a buffer of `fill`."""
    n, c, h, w = shape
    cw = c if channels is None else channels
    flat = torch.full((n * cw * h * w + 2 * GUARD,), fill, dtype=dtype, device=dev)
    st = (cw * h * w, 1, w * cw, cw) if rows else (cw * h * w, h * w, w, 1)
    return flat.as_strided((n, cw, h, w), st, GUARD)[:, first:first + c], flat


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_stay_inside_their_tensors(monkeypatch, dtype):
    """Every pass reads only its tensors' values and writes only its
    outputs: x and dy are views inside buffers of NaN (GUARD values before
    and after, and the other channels of a wider tensor), so a value read
    from outside them would poison the sums, and every output (y, dx, the
    partials, stat, coef, dweight, dbias) lies inside a buffer whose
    margins must come back untouched. At short last chunks in both
    layouts, channel slices of NCHW and channels-last tensors (aligned, and
    two channels in), dy in NCHW planes against channels last, planes of
    no whole vector, two rows tiles and the 20x20 maps, against the plain
    passes (_check_against_plain); the inputs come back bit for bit."""
    dev = _card()
    outs = []

    def guarded_out(x, rows):
        t, flat = _guarded(x.shape, x.dtype, rows, dev, 3.0)
        outs.append((flat, flat.clone(), t.numel()))
        return t

    def guarded_scratch(shape, x):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        numel = 1
        for d in shape:
            numel *= d
        flat = torch.full((numel + 2 * GUARD,), 3.0, device=dev)
        outs.append((flat, flat.clone(), numel))
        return flat[GUARD:GUARD + numel].view(shape)

    monkeypatch.setattr(bn_cuda, "dense_like", guarded_out)
    monkeypatch.setattr(bn_cuda, "scratch", guarded_scratch)
    # (shape, x's family, dy's family, channels of the wider tensor, first channel)
    cases = [((7, 4, 64, 64), 0, 0, None, 0), ((7, 24, 64, 64), 1, 1, None, 0),
             ((2, 64, 40, 40), 0, 0, 96, 16), ((2, 64, 40, 40), 1, 1, 96, 16),
             ((2, 60, 40, 40), 1, 1, 96, 2), ((2, 60, 40, 40), 0, 0, 96, 2),
             ((2, 64, 40, 40), 1, 0, 96, 16), ((3, 24, 15, 17), 0, 0, 40, 8),
             ((2, 2304, 4, 6), 1, 1, None, 0), ((2, 640, 20, 20), 1, 1, None, 0),
             ((2, 640, 20, 20), 0, 0, None, 0)]
    for shape, rows, dy_rows, channels, first in cases:
        vals = _inputs(shape, dtype=dtype, device=dev)
        (x, fx), (dy, fdy) = (_guarded(shape, dtype, r, dev, float("nan"), channels, first)
                              for r in (rows, dy_rows))
        x.copy_(vals[0])
        dy.copy_(vals[1])
        kept = [_bits(f).clone() for f in (fx, fdy)]
        outs.clear()
        k = _kernel_run(x, dy, True)
        torch.cuda.synchronize()
        what = f"{shape} {dtype} rows {rows}/{dy_rows} channels {first}+ of {channels}"
        assert k["plan"].rows == rows and k["gplan"].dy_planes == int(rows != dy_rows), what
        assert len(outs) == 8, what  # part, stat; y; part, coef, dweight, dbias; dx
        for flat, before, numel in outs:
            assert torch.equal(_bits(flat[:GUARD]), _bits(before[:GUARD])), what
            assert torch.equal(_bits(flat[GUARD + numel:]), _bits(before[GUARD + numel:])), what
        assert all(torch.equal(_bits(f), b) for f, b in zip((fx, fdy), kept)), what
        _check_against_plain(k, x, dy, True)


@pytest.mark.cuda
def test_graph_replay_equals_eager():
    """bn_silu forward and backward captured in a CUDA graph (channels last):
    a replay on new values gives the eager call's y, gradients and running
    statistics bit for bit, and the wrappers' launch counts move only with
    eager calls."""
    dev = _card()
    shape = (2, 160, 80, 80)
    x0, dy0 = (_layout(t, 1) for t in _inputs(shape, seed=1, dtype=torch.bfloat16, device=dev))
    x1, dy1 = (_layout(t, 1) for t in _inputs(shape, seed=2, dtype=torch.bfloat16, device=dev))
    bn = _bn(shape[1])
    w = bn.weight.detach().to(dev).requires_grad_()
    b = bn.bias.detach().to(dev).requires_grad_()
    rm, rv = bn.running_mean.to(dev), bn.running_var.to(dev)
    sx, sdy = x0.clone().requires_grad_(), dy0.clone()

    def step():
        y = bn_cuda.bn_silu(sx, w, b, rm, rv, bn.eps, BN_MOMENTUM, True)
        return (y,) + torch.autograd.grad(y, (sx, w, b), sdy)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up, as before a capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches()
    with torch.cuda.graph(graph):
        out = step()
    captured = _launches()
    assert [a - b for a, b in zip(captured, before)] == [2, 1, 2, 1]

    rm0, rv0 = rm.clone(), rv.clone()
    with torch.no_grad():
        sx.copy_(x1)
    sdy.copy_(dy1)
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in out] + [rm.clone(), rv.clone()]
    assert _launches() == captured
    rm.copy_(rm0)
    rv.copy_(rv0)
    eager = list(step()) + [rm, rv]
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          replayed, eager):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_training_forward_routes_on_card():
    """A 2-task yolov8n's training forward and backward on the card, a
    channels-last bfloat16 input and float32 weights as the train step holds
    them: every BatchNorm forward takes the kernels (FUSED counts them, PLAIN
    stays), six launches a BatchNorm, each output in its input's layout
    family as the PyTorch path leaves it (a conv fed a channel slice of a
    channels-last map writes NCHW), both families met, every gradient
    finite; in eval mode no route is counted."""
    dev = _card()
    model = CerberusModel(CFG, ["a", "b"], [3, 5], device="cpu").init(0).to(dev).train()
    forwards = []
    hooks = [m.register_forward_hook(lambda m, i, o: forwards.append((i[0], o)))
             for m in model.modules() if isinstance(m, BatchNorm)]
    x, _ = _inputs((2, 3, 128, 128), seed=3, dtype=torch.bfloat16, device=dev)
    x = _layout(x, 1)
    routes, launches = _routes(), _launches()
    out = model(x)
    sum(f.float().square().mean() for feats in out.values() for f in feats).backward()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert _routes() == (routes[0] + len(forwards), routes[1])
    assert [a - b for a, b in zip(_launches(), launches)] == [2 * len(forwards), len(forwards),
                                                               2 * len(forwards), len(forwards)]
    families = [bn_cuda.strides(i)[0] for i, _ in forwards]
    assert [bn_cuda.strides(o)[0] for _, o in forwards] == families
    assert set(families) == {0, 1}
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)
    model.eval()
    routes = _routes()
    with torch.no_grad():
        model(x)
    assert _routes() == routes
