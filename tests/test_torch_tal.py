"""Port's task-aligned assigner (cerberusdet_tpu_torch/train/tal.py, the plain
version of the kernels in ops/tal_cuda.py) against the JAX package's
TaskAlignedAssigner and assign_pallas in interpret mode.

Labels, fg mask, gt index and boxes must be equal; target scores within
rtol 1e-5, atol 1e-6 (tests/test_tal_pallas.py's tolerance: the arctan and
the powers may round one ulp apart between the two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.ops.tal_pallas import assign_pallas
from cerberusdet_tpu.train.tal import TaskAlignedAssigner as JaxAssigner
from cerberusdet_tpu_torch.ops import tal_cuda
from cerberusdet_tpu_torch.ops.tal_cuda import (
    TaskAlignedAssigner,
    selection_mask,
    task_aligned_assign,
)
from cerberusdet_tpu_torch.testing import (
    crowded_tal_scene,
    norm_scene,
    sparse_tal_scene,
    tal_scene,
    tied_tal_scene,
)
from cerberusdet_tpu_torch.train.tal import select_candidates_in_gts, topk_first

SCENES = {
    "random0": (lambda: tal_scene(0), 7),
    "random1": (lambda: tal_scene(1), 7),
    "random2": (lambda: tal_scene(2), 7),
    "dense": (lambda: tal_scene(5, dense=True, M=16), 7),
    "empty_row": (lambda: tal_scene(3, empty_first=True), 7),
    "m40": (lambda: tal_scene(7, M=40, N=384), 7),
    "tied_zeros": (lambda: tied_tal_scene(0), 5),
    "tied_zeros_b": (lambda: tied_tal_scene(1, B=3, M=16), 5),
    "crowded": (lambda: crowded_tal_scene(0), 7),
    "sparse": (lambda: sparse_tal_scene(4), 7),
}
EXACT = ("target_labels", "fg_mask", "target_gt_idx", "target_bboxes")


def _ours(scene, nc):
    return task_aligned_assign(*[torch.from_numpy(x) for x in scene], topk=10,
                               num_classes=nc)


def _assert_same(ours, ref):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(ours.target_scores.numpy(), np.asarray(ref.target_scores),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_assigner_matches_jax_xla(name):
    make, nc = SCENES[name]
    scene = make()
    ref = JaxAssigner(topk=10, num_classes=nc)(*[jnp.asarray(x) for x in scene])
    ours = _ours(scene, nc)
    _assert_same(ours, ref)
    assert ours.fg_mask.any()
    if name == "empty_row":
        assert not ours.fg_mask[0].any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_assigner_matches_jax_pallas_interpret(name):
    make, nc = SCENES[name]
    scene = make()
    ref = assign_pallas(*[jnp.asarray(x) for x in scene], topk=10, num_classes=nc,
                        interpret=True)
    _assert_same(_ours(scene, nc), ref)


def test_scenes_exercise_ties_and_multi_assignment():
    """The tied scene really selects anchors whose metric is 0 (only the
    lowest-index rule decides them), labels out of [0, nc) are clipped, and
    valid gts are not a prefix; the dense scene resolves anchors claimed by
    several gts."""
    scene = tied_tal_scene(0)
    t = [torch.from_numpy(x) for x in scene]
    plain = TaskAlignedAssigner(topk=10, num_classes=5)
    labels = t[3].clamp(0, 4)
    mask_pos, overlaps, align = plain.select_topk(t[0], t[1], t[2], labels, t[4], t[5])
    assert ((mask_pos > 0) & (align == 0)).sum() > 5
    assert not scene[5][:, 0].any() and scene[5][:, 1].all()
    assert (scene[3] < 0).any() and (scene[3] >= 5).any()
    dense = [torch.from_numpy(x) for x in tal_scene(5, dense=True, M=16)]
    mask_pos, _, _ = plain.select_topk(dense[0], dense[1], dense[2], dense[3].clamp(0, 6),
                                       dense[4], dense[5])
    assert (mask_pos.sum(1) > 1).any()


def test_crowded_scene_claims_most_anchors_several_times():
    """In the crowded scene (one kernel block of 256 anchors) most anchors of
    each image are claimed by several gts: tal_assign resolves them by its
    warp-wide argmax over all M rows."""
    t = [torch.from_numpy(x) for x in crowded_tal_scene(0)]
    mask_pos, _, _ = TaskAlignedAssigner(topk=10, num_classes=7).select_topk(*t)
    count = (mask_pos > 0).sum(1)
    assert t[0].shape[1] == 256 and ((count > 1).float().mean(1) > 0.5).all()


def test_sparse_scene_has_a_row_with_fewer_than_k_inside():
    """The sparse scene: N 333 (not a multiple of 32), and in each image a
    valid gt holding 1..9 anchors, so its top-10 reaches zeros outside it."""
    t = [torch.from_numpy(x) for x in sparse_tal_scene(4)]
    inside = select_candidates_in_gts(t[2], t[4])[:, 0].sum(-1)
    assert t[0].shape[1] % 32 and ((inside >= 1) & (inside < 10)).all() and t[5][:, 0].all()


# ------------------------------------------- a CPU model of tal_select's design

_EMPTY = (0, 0xFFFFFFFF)  # a list entry past a warp's anchors: key 0


def _keys(metrics):
    """csrc/tal.cu:metric_key: the bits of v + 0 (so -0 ties +0), plus one."""
    v = np.asarray(metrics, np.float32) + np.float32(0.0)
    return v.view(np.uint32).astype(np.int64) + 1


def _select_model(metrics, inside, k, warps):
    """tal_select's decomposition of one gt row, in numpy: warp w of `warps`
    takes the 32-anchor chunks w, w + warps, ..., lane l the anchors
    32 (w + warps j) + l; a warp's list is its first-occurrence top-k by
    (max key, then min index holding it) reductions over the lanes' bests,
    the owner of each pick (lane pick % 32) dropping it (the kernel keeps a
    lane's 4 best in registers and rescans when they run out, which yields
    the same bests), and a key-0 entry where the warp runs out; one warp then
    merges the lists' heads k times under the same order. Returns the row of
    sel."""
    keys = _keys(metrics)
    n = len(keys)

    def lane_best(w_keys, w, lane):
        idx = np.arange(32 * w + lane, n, 32 * warps)
        if not len(idx) or w_keys[idx].max() == 0:
            return _EMPTY
        j = int(np.argmax(w_keys[idx]))  # the first maximum in index order
        return int(w_keys[idx[j]]), int(idx[j])

    def best(entries):
        mk = max(e[0] for e in entries)
        return mk, min(e[1] for e in entries if e[0] == mk)

    lists = []
    for w in range(warps):
        w_keys = keys.copy()
        lanes = [lane_best(w_keys, w, lane) for lane in range(32)]
        out = []
        for _ in range(k):
            mk, mi = best(lanes)
            out.append((mk, mi))
            if mk == 0:
                break
            owner = mi % 32
            w_keys[mi] = 0
            lanes[owner] = lane_best(w_keys, w, owner)
        lists.append(out)
    heads = [0] * warps
    sel = []
    for _ in range(k):
        entries = [lists[w][heads[w]] if heads[w] < len(lists[w]) else _EMPTY
                   for w in range(warps)]
        mk, mi = best(entries)
        assert mk > 0, "the merge reached an empty entry"
        heads[[e == (mk, mi) for e in entries].index(True)] += 1
        sel.append(mi if inside[mi] else -1)
    return sel


def _row_assignment_model(mask, grid, threads=256):
    """tal_select's share-out of the gt rows (B * M flat) over a grid of
    `grid` blocks: thread t of every block counts the valid rows of its
    slice [t * per, (t + 1) * per), an exclusive prefix over the threads
    ranks them, and block j takes the valid rows of rank j, j + grid, ...
    and writes the -1s of the rows r = j, j + grid, ... that are not valid.
    Returns ({block: valid rows}, {block: rows it writes -1 for})."""
    rows = len(mask)
    per = -(-rows // threads)
    starts = [min(t * per, rows) for t in range(threads)]
    counts = [int(mask[a:min(a + per, rows)].sum()) for a in starts]
    rank0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    valid, empty = {}, {}
    for j in range(grid):
        valid[j], empty[j] = [], []
        for t, a in enumerate(starts):
            rank = int(rank0[t])
            for r in range(a, min(a + per, rows)):
                if mask[r]:
                    if rank % grid == j:
                        valid[j].append(r)
                    rank += 1
                elif r % grid == j:
                    empty[j].append(r)
    return valid, empty


@pytest.mark.parametrize("rows,grid,share", [(2400, 396, 40 / 300), (2400, 264, 40 / 300),
                                             (24, 24, 0.6), (300, 7, 1.0), (5000, 3, 0.5)])
def test_row_assignment_model(rows, grid, share):
    """Every valid row goes to exactly one block, every other row's -1s are
    written by exactly one block, the valid rows spread evenly (a block
    takes at most one more than another) and no block takes more than its
    256 threads' worth, at the launcher's grid: max(what the card holds,
    rows / 256), at most the rows. The flagship case: 2400 rows, 40 of each
    300 valid, 264 or 396 blocks."""
    mask = np.random.default_rng(rows).uniform(0, 1, rows) < share
    if share == 40 / 300:
        mask = (np.arange(rows) % 300) < 40
    grid = min(max(grid, -(-rows // 256)), rows)
    valid, empty = _row_assignment_model(mask, grid)
    got_valid = sorted(r for v in valid.values() for r in v)
    got_empty = sorted(r for v in empty.values() for r in v)
    assert got_valid == list(np.nonzero(mask)[0]) and got_empty == list(np.nonzero(~mask)[0])
    sizes = [len(v) for v in valid.values()]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= 256


def _plain_select(metrics, inside, k):
    idx = topk_first(torch.from_numpy(np.asarray(metrics, np.float32)), k).numpy()
    return [int(i) if inside[i] else -1 for i in idx]


def _model_rows():
    """(name, metrics, inside) rows that stress the top-k's ties and edges."""
    rng = np.random.default_rng(0)
    rows = []
    n = 300
    rows.append(("all zero", np.zeros(n, np.float32), rng.uniform(0, 1, n) < 0.3))
    m = np.zeros(1000, np.float32)
    m[rng.choice(1000, 3, replace=False)] = rng.uniform(0.1, 1, 3)
    rows.append(("3 positives", m, m > 0))
    m = rng.choice(np.float32([0.0, 0.25, 0.5]), 777)
    rows.append(("three values, many ties", m, rng.uniform(0, 1, 777) < 0.5))
    m = rng.uniform(0, 1, 8400).astype(np.float32)
    m[rng.uniform(0, 1, 8400) < 0.3] = 0.0
    rows.append(("N 8400", m, m > 0))
    rows.append(("N < k", rng.uniform(0, 1, 5).astype(np.float32), np.ones(5, bool)))
    m = rng.choice(np.float32([0.0, -0.0, 0.5]), 333)
    rows.append(("N 333, -0 beside +0", m, rng.uniform(0, 1, 333) < 0.5))
    m = np.full(257, 0.5, np.float32)
    rows.append(("N 257, all equal", m, np.arange(257) % 3 == 0))
    return rows


@pytest.mark.parametrize("warps", [8, 3, 32])
@pytest.mark.parametrize("row", range(len(_model_rows())))
def test_select_model_matches_plain_topk(row, warps):
    """The kernel's per-warp top-k and merge (8 warps; 3 and 32 too, since
    the union argument holds for any split) select exactly the plain
    stable-sort top-k, on tie-heavy rows: all zero, fewer than k positives,
    three values, N 8400, N < k (k = N, as the wrapper sets it), -0 beside
    +0, N not a multiple of 32 or of the block."""
    name, metrics, inside = _model_rows()[row]
    k = min(10, len(metrics))
    assert _select_model(metrics, inside, k, warps) == _plain_select(metrics, inside, k), name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_select_model_matches_plain_on_scenes(name):
    """The same model on every valid gt row of the test scenes, against the
    plain stage 1's positives (before resolving)."""
    make, nc = SCENES[name]
    t = [torch.from_numpy(x) for x in make()]
    plain = TaskAlignedAssigner(topk=10, num_classes=nc)
    labels = t[3].clamp(0, nc - 1)
    mask_pos, _, align = plain.select_topk(t[0], t[1], t[2], labels, t[4], t[5])
    in_gts = select_candidates_in_gts(t[2], t[4])
    metrics = (align * in_gts).numpy()
    n = metrics.shape[-1]
    k = min(10, n)
    for b, m in zip(*np.nonzero(t[5].numpy())):
        sel = _select_model(metrics[b, m], in_gts[b, m].numpy(), k, 8)
        want = np.zeros(n, bool)
        want[[i for i in sel if i >= 0]] = True
        np.testing.assert_array_equal(mask_pos[b, m].numpy() > 0, want, err_msg=f"{name} {b} {m}")


# ------------------------------------------- a CPU model of tal_norm's design


def _plain_norm(tgt, fg, labels, align, pos, nc, eps=1e-9):
    """The plain stage 3 (TaskAlignedAssigner.normalise) on tal_norm's
    per-anchor inputs: the resolved mask and the align metric scattered to
    (B, M, N) at each anchor's gt."""
    t = [torch.from_numpy(x) for x in (tgt, fg, labels, align, pos)]
    tgt, fg, labels, align, pos = t
    b, n = tgt.shape
    m = pos.shape[1]
    mask_pos = torch.zeros((b, m, n)).scatter_(1, tgt[:, None], fg[:, None].float())
    align3 = torch.zeros((b, m, n)).scatter_(1, tgt[:, None], align[:, None])
    plain = TaskAlignedAssigner(10, nc, eps=eps)
    return plain.normalise(labels, fg, mask_pos, align3, pos[..., 0], pos[..., 1],
                           torch.float32).numpy()


def _norm_model(tgt, fg, labels, align, pos, nc, eps=1e-9, block=256):
    """tal_norm's decomposition, in numpy: a block per `block` anchors of
    the flat (B * N) range; phase 1 a thread per anchor, its class (-1 for
    background) and value v = align * pos_ov / (pos_align + eps) rounded at
    each operation; phase 2 the block's contiguous block * nc floats from
    a0 * nc, swept as 4-float stores (anchor and class of the first element
    by division, then stepped by one with a wrap at nc, as the kernel
    steps), and the ragged tail one float at a time. Returns (the output
    (B, N, nc), the count of writes per element, the byte offsets of the
    vector stores)."""
    b, n = tgt.shape
    anchors = b * n
    img = np.arange(anchors) // n
    p = pos[img, tgt.reshape(-1)]                                # (anchors, 2)
    eps32 = np.float32(eps)
    val = np.where(fg.reshape(-1), (align.reshape(-1) * p[:, 1]) / (p[:, 0] + eps32),
                   np.float32(0.0)).astype(np.float32)
    cls = np.where(fg.reshape(-1), labels.reshape(-1), -1)
    out = np.full(anchors * nc, np.nan, np.float32)
    writes = np.zeros(anchors * nc, np.int64)
    offsets = []
    for a0 in range(0, anchors, block):
        s_cls, s_val = cls[a0:a0 + block], val[a0:a0 + block]
        count = len(s_cls) * nc
        base = a0 * nc
        q = np.arange(count >> 2)
        e = q * 4
        an, c = e // nc, e % nc
        for j in range(4):
            idx = base + e + j
            out[idx] = np.where(s_cls[an] == c, s_val[an], np.float32(0.0))
            np.add.at(writes, idx, 1)
            c = c + 1
            wrap = c == nc
            c[wrap] = 0
            an = an + wrap
        offsets.append(4 * (base + e))
        for t in range(len(q) * 4, count):
            out[base + t] = s_val[t // nc] if s_cls[t // nc] == t % nc else np.float32(0.0)
            writes[base + t] += 1
    return out.reshape(b, n, nc), writes, np.concatenate(offsets)


@pytest.mark.parametrize("nc", [1, 19, 20, 80])
@pytest.mark.parametrize("n", [5, 333, 8400])
@pytest.mark.parametrize("b", [1, 8])
def test_norm_model_matches_plain(b, n, nc):
    """tal_norm's index map writes every output element exactly once, every
    vector store lands on a 16-byte boundary (the output's base is 16-byte
    aligned), and the values equal the plain normalise bit for bit: nc not a
    multiple of 4 (19, 1), B * N not a multiple of the 256-anchor block."""
    inputs = norm_scene(b * 100 + n + nc, b, n, 12, nc)
    got, writes, offsets = _norm_model(*inputs, nc)
    assert (writes == 1).all()
    assert (offsets % 16 == 0).all()
    np.testing.assert_array_equal(got.view(np.uint32), _plain_norm(*inputs, nc).view(np.uint32))


def test_norm_model_all_background():
    """An all-background batch: +0 everywhere."""
    inputs = norm_scene(5, 3, 333, 12, 19, fg_share=0.0)
    got, writes, _ = _norm_model(*inputs, 19)
    assert (writes == 1).all() and (got.view(np.uint32) == 0).all()
    assert (_plain_norm(*inputs, 19).view(np.uint32) == 0).all()


def test_selection_mask():
    sel = torch.tensor([[[2, -1, 0], [-1, -1, -1]]], dtype=torch.int32)
    mask = selection_mask(sel, 4)
    assert mask.tolist() == [[[True, False, True, False], [False] * 4]]


def test_wrapper_takes_plain_version_on_cpu():
    scene = tal_scene(0)
    before = (tal_cuda.select_kernel.launches, tal_cuda.assign_kernel.launches,
              tal_cuda.norm_kernel.launches)
    a = _ours(scene, 7)
    b = TaskAlignedAssigner(10, 7)(*[torch.from_numpy(x) for x in scene])
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (tal_cuda.select_kernel.launches, tal_cuda.assign_kernel.launches,
            tal_cuda.norm_kernel.launches) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: the three kernels against the plain version, exactly on
    every integer and bool output, scores within rtol 1e-5, atol 1e-6; and
    tal_select's rows against the plain top-k where N is below k, not a
    multiple of 32, or the flagship's 8400."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scenes = dict(SCENES)
    scenes.update({f"sparse N{n}": ((lambda n=n: sparse_tal_scene(5, N=n)), 7)
                   for n in (5, 257, 8400)})
    for name, (make, nc) in sorted(scenes.items()):
        scene = [torch.from_numpy(x).cuda() for x in make()]
        before = tal_cuda.select_kernel.launches
        k = task_aligned_assign(*scene, topk=10, num_classes=nc)
        p = task_aligned_assign(*scene, topk=10, num_classes=nc, use_kernel=False)
        torch.cuda.synchronize()
        assert tal_cuda.select_kernel.launches == before + 1
        for f in EXACT:
            assert torch.equal(getattr(k, f), getattr(p, f)), (name, f)
        torch.testing.assert_close(k.target_scores, p.target_scores, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_norm_kernel_matches_plain_on_card():
    """On the card: tal_norm bit for bit with the plain normalise at the
    flagship's B 8, N 8400, nc 20, at nc 19 and 1, on an all-background
    batch and where B * N is not a multiple of the 256-anchor block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, n, nc, share in [(8, 8400, 20, 0.3), (8, 8400, 19, 0.3), (3, 333, 1, 0.5),
                            (3, 333, 19, 0.0), (1, 5, 80, 1.0)]:
        inputs = norm_scene(n + nc, b, n, 12, nc, fg_share=share)
        t = [torch.from_numpy(x).cuda() for x in inputs]
        got = tal_cuda.norm_kernel(*t, nc, 1e-9)
        torch.cuda.synchronize()
        want = _plain_norm(*inputs, nc)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))
