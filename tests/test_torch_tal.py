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
from cerberusdet_tpu_torch.testing import crowded_tal_scene, tal_scene, tied_tal_scene

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
    every integer and bool output, scores within rtol 1e-5, atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, (make, nc) in sorted(SCENES.items()):
        scene = [torch.from_numpy(x).cuda() for x in make()]
        before = tal_cuda.select_kernel.launches
        k = task_aligned_assign(*scene, topk=10, num_classes=nc)
        p = task_aligned_assign(*scene, topk=10, num_classes=nc, use_kernel=False)
        torch.cuda.synchronize()
        assert tal_cuda.select_kernel.launches == before + 1
        for f in EXACT:
            assert torch.equal(getattr(k, f), getattr(p, f)), (name, f)
        torch.testing.assert_close(k.target_scores, p.target_scores, rtol=1e-5, atol=1e-6)
