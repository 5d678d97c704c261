"""Port's NMS (cerberusdet_tpu_torch/ops/nms.py, ops/nms_cuda.py) against the
JAX package's: greedy selection, candidate choice, cross-task suppression.

All selections must be IDENTICAL (indices, counts, rows bit for bit): both
sides compute the IoU in float32 in the same operation order. The CUDA
kernel test needs the card and skips without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.ops.nms import cross_task_suppress as jax_cross_task
from cerberusdet_tpu.ops.nms import greedy_nms as jax_greedy
from cerberusdet_tpu.ops.nms import non_max_suppression as jax_nms
from cerberusdet_tpu.ops.nms_pallas import greedy_nms_pallas
from cerberusdet_tpu_torch.ops.nms import cross_task_suppress, greedy_nms, non_max_suppression
from cerberusdet_tpu_torch.ops.nms_cuda import MAX_K, greedy_nms_cuda
from cerberusdet_tpu_torch.testing import (
    boundary_candidates,
    duplicate_candidates,
    random_candidates,
)
from test_nms import _reference_cross_task
from test_nms_pallas import _random_candidates


def _plain(boxes, scores, thr, max_det):
    idx, valid = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_det)
    return idx.numpy(), valid.numpy()


@pytest.mark.parametrize("B,K,zeros", [(3, 512, 300), (8, 1024, None), (9, 256, 100)])
def test_plain_greedy_matches_jax_and_pallas(B, K, zeros):
    """Same cases as tests/test_nms_pallas.py: identical idx and valid
    against jax greedy_nms and the Pallas kernel in interpret mode."""
    boxes, scores = _random_candidates(B, K, seed=B, zeros_from=zeros)
    idx, valid = _plain(boxes, scores, 0.5, 300)
    idx_p, val_p = greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 300,
                                     interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(idx_p))
    np.testing.assert_array_equal(valid, np.asarray(val_p))
    for b in range(B):
        idx_r, val_r = jax_greedy(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.5, 300)
        np.testing.assert_array_equal(idx[b], np.asarray(idx_r))
        np.testing.assert_array_equal(valid[b], np.asarray(val_r))


@pytest.mark.parametrize("thr", [0.45, 0.7])
def test_plain_greedy_boundary_iou(thr):
    """IoUs within one float32 ulp of the threshold, on both sides: the same
    boxes are suppressed as by jax greedy_nms and by the Pallas kernel."""
    boxes, scores, iou = boundary_candidates(thr)
    f = np.float32(thr)
    assert (np.abs(iou - f) <= np.spacing(f)).all()
    idx, valid = _plain(boxes, scores, thr, 2)
    idx_p, val_p = greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, 2,
                                     interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(idx_p))
    np.testing.assert_array_equal(valid, np.asarray(val_p))
    for b in range(len(boxes)):
        idx_r, val_r = jax_greedy(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr, 2)
        np.testing.assert_array_equal(idx[b], np.asarray(idx_r))
        np.testing.assert_array_equal(valid[b], np.asarray(val_r))
    # B is suppressed exactly where its IoU is above float32(thr)
    np.testing.assert_array_equal(valid[:, 1], iou <= f)
    assert valid[:, 1].any() and not valid[:, 1].all()


def test_plain_greedy_all_zero_and_ties():
    """Duplicate scores go to the lower index; with nothing live the pick is
    index 0 with valid False (the Pallas kernel's rule)."""
    boxes, scores = _random_candidates(2, 64, seed=5)
    scores = np.round(scores, 1)
    scores[1] = 0.0
    idx, valid = _plain(boxes, scores, 0.45, 80)
    for b in range(2):
        idx_r, val_r = jax_greedy(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.45, 80)
        np.testing.assert_array_equal(idx[b], np.asarray(idx_r))
        np.testing.assert_array_equal(valid[b], np.asarray(val_r))
    assert not valid[1].any() and (idx[1] == 0).all()


def _signed_zeros(boxes, scores):
    """Every 17th score -0.0 (<= 0: invalid, and equal to +0.0 in the argmax)."""
    scores = scores.copy()
    scores[:, ::17] = -0.0
    return boxes, scores


def _negative_tail():
    """Few positives among negative scores. Indices 0 (negative) and 1 (0)
    share a box far from the rest: once the positives run out the lowest 0 is
    index 1, whose pick zeroes index 0, which is picked from then on."""
    boxes, scores = random_candidates(2, 600, seed=8, zeros_from=40, low=-0.5,
                                      size=(40, 200))
    boxes[:, :2] = [1000.0, 1000.0, 1100.0, 1100.0]
    scores[:, 0], scores[:, 1] = -0.3, 0.0
    return boxes, scores


# the redesigned kernel's paths (csrc/nms.cu): scores <= 0 after the positive
# picks run out, positives that fill shared memory, one image, ties between
# copies of one box
KERNEL_CASES = {
    "negative and -0.0 scores": (lambda: _signed_zeros(*random_candidates(
        3, 700, seed=7, low=-0.5, classes=3)), 0.45, 300),
    "few positives among negatives": (_negative_tail, 0.45, 300),
    "K8400 all positive": (lambda: random_candidates(
        2, 8400, seed=9, low=0.01, classes=20), 0.45, 300),
    "B1": (lambda: random_candidates(1, 2000, seed=10, size=(60, 300)), 0.7, 300),
    "duplicates with tied scores": (lambda: duplicate_candidates(2, 900, seed=11), 0.45, 300),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_plain_greedy_matches_jax_on_kernel_cases(name):
    """The plain loop, which the kernel must match, against jax greedy_nms
    and the Pallas kernel in interpret mode: identical idx and valid."""
    make, thr, max_det = KERNEL_CASES[name]
    boxes, scores = make()
    idx, valid = _plain(boxes, scores, thr, max_det)
    idx_p, val_p = greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, max_det,
                                     interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(idx_p))
    np.testing.assert_array_equal(valid, np.asarray(val_p))
    for b in range(boxes.shape[0]):
        idx_r, val_r = jax_greedy(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), thr, max_det)
        np.testing.assert_array_equal(idx[b], np.asarray(idx_r))
        np.testing.assert_array_equal(valid[b], np.asarray(val_r))


def test_kernel_cases_reach_their_paths():
    """Each case reaches what it is named for: scores <= 0 picked after the
    positives run out (and some of them more than once), every score
    positive, copies of a box suppressed by their first."""
    boxes, scores = KERNEL_CASES["few positives among negatives"][0]()
    idx, valid = _plain(boxes, scores, 0.45, 300)
    assert (scores < 0).sum() > 300 and (valid.sum(1) < 40).all() and not valid[:, -1].any()
    for b in range(2):
        tail = idx[b][~valid[b]]
        assert tail[0] == 1 and set(tail[1:]) == {0}
    boxes, scores = KERNEL_CASES["negative and -0.0 scores"][0]()
    assert np.signbit(scores[scores == 0]).any() and (scores < 0).any()
    assert (KERNEL_CASES["K8400 all positive"][0]()[1] > 0).all()
    boxes, scores = KERNEL_CASES["duplicates with tied scores"][0]()
    idx, valid = _plain(boxes, scores, 0.45, 300)
    for b in range(2):
        for j in idx[b][valid[b]]:
            copies = np.flatnonzero((boxes[b] == boxes[b, j]).all(1))
            assert len(copies) >= 2 and j == copies.min()


def _pred(B, N, nc, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(100, 500, (B, N, 2)), rng.uniform(10, 80, (B, N, 2)),
        rng.uniform(0, 1, (B, N, nc)) ** 3,
    ], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(multi_label=False),
    dict(multi_label=True),
    dict(multi_label=False, max_nms=100),
    dict(multi_label=True, max_nms=150),
    dict(multi_label=False, agnostic=True, classes=(0, 2)),
])
def test_non_max_suppression_matches_jax(kw):
    """Candidate choice (incl. the stable top-k under the max_nms cap),
    class offsets and the output rows: identical to the JAX XLA path."""
    pred = _pred(2, 300, 3, seed=len(kw))
    dj, cj = jax_nms(jnp.asarray(pred), nc=3, conf_thres=0.2, iou_thres=0.45,
                     max_det=100, use_pallas=False, **kw)
    dt, ct = non_max_suppression(torch.from_numpy(pred), nc=3, conf_thres=0.2,
                                 iou_thres=0.45, max_det=100, **kw)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int(ct.min()) > 0


def test_non_max_suppression_kernel_path_clamp_on_cpu():
    """use_kernel=True clamps max_nms to the kernel's 16384 candidates; on a
    CPU tensor the wrapper runs the plain loop, so this equals the JAX path
    with the same clamp."""
    pred = _pred(1, 200, 120, seed=7)  # 24000 (anchor, class) pairs > 16384
    kw = dict(nc=120, conf_thres=0.05, multi_label=True, max_det=60)
    dj, cj = jax_nms(jnp.asarray(pred), use_pallas=False, max_nms=MAX_K, **kw)
    dt, ct = non_max_suppression(torch.from_numpy(pred), use_kernel=True, **kw)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


VAL_NMS = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, multi_label=True)


def test_kernel_path_clamp_invisible_at_val_traffic():
    """The val protocol (conf 0.001, multi-label) on dense clustered
    predictions, ~166k candidates an image: the kernel path's 16384 cap
    selects the same 300 rows as the plain path's 30000, which equals the
    JAX XLA path (no clamp) bit for bit. Same data as
    tests/test_nms_clamp.py."""
    rng = np.random.default_rng(0)
    B, N, nc = 4, 8400, 20
    centers = rng.uniform(100, 540, (B, 40, 2))
    pick = rng.integers(0, 40, (B, N))
    xy = centers[np.arange(B)[:, None], pick] + rng.normal(0, 30, (B, N, 2))
    wh = rng.uniform(20, 120, (B, N, 2))
    scores = rng.uniform(0.0005, 0.05, (B, N, nc)).astype(np.float32)
    strong = rng.integers(0, N, (B, 50))
    for b in range(B):
        scores[b, strong[b], rng.integers(0, nc, 50)] = rng.uniform(0.3, 0.95, 50)
    pred = np.concatenate([np.concatenate([xy, wh], -1), scores], -1).astype(np.float32)
    assert (scores > 0.001).sum() / B > 100_000
    dk, ck = non_max_suppression(torch.from_numpy(pred), nc=nc, use_kernel=True, **VAL_NMS)
    dp, cp = non_max_suppression(torch.from_numpy(pred), nc=nc, **VAL_NMS)
    dj, cj = jax_nms(jnp.asarray(pred), nc=nc, use_pallas=False, **VAL_NMS)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ck.numpy(), cp.numpy())
    for b in range(B):  # the same rows; the order may differ on equal scores
        k = {tuple(r) for r in dk[b, : int(ck[b])].tolist()}
        assert k == {tuple(r) for r in dp[b, : int(cp[b])].tolist()}


def test_clamp_follows_the_route():
    """Only the kernel path clamps: >16384 near-identical boxes that
    outscore 50 small ones leave 1 detection at 16384 candidates and 51 at
    30000 (the boundary of tests/test_nms_clamp.py); the plain path keeps
    JAX's unclamped answer."""
    N = 18050
    pred = np.zeros((1, N, 5), np.float32)
    pred[0, :18000, :4] = [300, 300, 40, 40]
    pred[0, :18000, :4] += np.random.default_rng(0).normal(0, 0.5, (18000, 4))
    pred[0, :18000, 4] = np.linspace(0.9, 0.5, 18000)
    for i in range(50):
        pred[0, 18000 + i, :4] = [30 + 12 * i, 30 + 12 * i, 10, 10]
        pred[0, 18000 + i, 4] = 0.1
    kw = dict(VAL_NMS, multi_label=False)
    _, ck = non_max_suppression(torch.from_numpy(pred), nc=1, use_kernel=True, **kw)
    _, cp = non_max_suppression(torch.from_numpy(pred), nc=1, use_kernel=False, **kw)
    _, cj = jax_nms(jnp.asarray(pred), nc=1, use_pallas=False, **kw)
    assert int(ck[0]) == 1 and int(cp[0]) == int(cj[0]) == 51


def _task_major_cases(n_cases, seed):
    """Batches of random task-major detection sets built like the differential
    fuzz of tests/test_nms.py: clustered boxes, occasional exact ties,
    padding rows."""
    rng = np.random.default_rng(seed)
    for case in range(n_cases):
        T = int(rng.integers(2, 4))
        per_task = int(rng.integers(3, 12))
        B, m = 4, T * per_task
        n_clusters = int(rng.integers(1, 4))
        centers = rng.uniform(20, 180, (n_clusters, 2))
        xy = centers[rng.integers(0, n_clusters, (B, m))] + rng.uniform(-6, 6, (B, m, 2))
        wh = rng.uniform(20, 40, (B, m, 2)) * rng.uniform(0.9, 1.1, (B, m, 1))
        conf = rng.uniform(0.1, 1.0, (B, m))
        if case % 3 == 0:
            conf = np.round(conf, 1) + 0.05
        dets = np.concatenate([xy - wh / 2, xy + wh / 2, conf[..., None],
                               rng.integers(0, 3, (B, m, 1))], -1).astype(np.float32)
        dets[rng.uniform(size=(B, m)) < 0.15, 4] = 0.0
        task_idx = np.repeat(np.arange(T), per_task).astype(np.int32)
        yield dets, task_idx, float(rng.choice([0.3, 0.5, 0.8])), (T - 1) * per_task


def test_cross_task_suppress_matches_jax_and_reference():
    """60 random batches: the batched port equals JAX cross_task_suppress per
    image, with and without the scan_rows bound, and the verbatim port of
    the reference loop from tests/test_nms.py."""
    for dets, task_idx, thr, scan_rows in _task_major_cases(60, seed=11):
        ours = cross_task_suppress(torch.from_numpy(dets), torch.from_numpy(task_idx), thr)
        bounded = cross_task_suppress(torch.from_numpy(dets), torch.from_numpy(task_idx),
                                      thr, scan_rows=scan_rows)
        np.testing.assert_array_equal(ours.numpy(), bounded.numpy())
        for b in range(dets.shape[0]):
            ref = np.asarray(jax_cross_task(jnp.asarray(dets[b]), jnp.asarray(task_idx), thr))
            np.testing.assert_array_equal(ours[b].numpy(), ref)
            np.testing.assert_array_equal(ref, _reference_cross_task(dets[b], task_idx, thr))


def test_kernel_wrapper_takes_plain_loop_on_cpu():
    """On CPU tensors the wrapper is the plain loop and launches nothing."""
    boxes, scores = _random_candidates(2, 128, seed=3)
    before = greedy_nms_cuda.launches
    idx, valid = greedy_nms_cuda(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 50)
    idx_p, valid_p = _plain(boxes, scores, 0.45, 50)
    np.testing.assert_array_equal(idx.numpy(), idx_p)
    np.testing.assert_array_equal(valid.numpy(), valid_p)
    assert greedy_nms_cuda.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel selects exactly what the plain loop selects, on the
    cases above and at K 16384 (slots beyond shared memory in global
    scratch; with large boxes the survivors move back into shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    cases = [(random_candidates(8, 8400, seed=1, zeros_from=6000, classes=20), 0.45),
             (random_candidates(8, MAX_K, seed=2), 0.7),
             (random_candidates(8, MAX_K, seed=3, low=0.01), 0.7),
             (random_candidates(8, MAX_K, seed=4, low=0.01, size=(150, 400)), 0.45),
             (boundary_candidates(0.45)[:2], 0.45), (boundary_candidates(0.7)[:2], 0.7)]
    cases += [(make(), thr) for make, thr, _ in KERNEL_CASES.values()]
    for (boxes, scores), thr in cases:
        b = torch.from_numpy(boxes).cuda()
        s = torch.from_numpy(scores).cuda()
        idx_k, val_k = greedy_nms_cuda(b, s, thr, 300)
        idx_p, val_p = greedy_nms(b, s, thr, 300)
        torch.cuda.synchronize()
        assert torch.equal(idx_k, idx_p) and torch.equal(val_k, val_p)
