"""The COCO matcher: its plain PyTorch version against the JAX ``match_batch``, and the kernel's launcher.

The CUDA kernel (``csrc/coco_match.cu``) runs only on the card, where
``chip_smoke.py`` holds it equal (``torch.equal``) to the plain version;
here the plain version must equal JAX's matcher exactly (both are boolean
maps) on padded items with tied IoUs, crowd and ignored ground truths,
IoUs of exactly 1.0 at ``thr=1.0``, invalid and all ``-inf`` detection rows,
and the launcher must refuse what the kernel does not take, before any
build or launch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.detection import matcher as jmatch
from torchmetrics_tpu_torch.functional.detection import matcher as tmatch
from torchmetrics_tpu_torch.kernels import coco_match as kcm

THRS = np.round(np.arange(0.5, 1.0, 0.05), 2).astype(np.float32)


def _batch(seed, b=6, d=16, g=8, a=4, ties=True):
    rng = np.random.default_rng(seed)
    ious = rng.uniform(0, 1, (b, d, g)).astype(np.float32)
    if ties:  # a coarse grid: equal IoUs in a row, and IoUs on the thresholds
        ious = (np.round(ious * 20) / 20).astype(np.float32)
    ious[:, 0, 0] = 1.0  # exactly 1.0: eligible at thr=1.0
    ious[0, 1] = 0.75  # one row all equal: the last index must win
    crowd = rng.uniform(size=(b, g)) < 0.2
    ignored = crowd[:, None, :] | (rng.uniform(size=(b, a, g)) < 0.3)
    ignored[1] = True  # an item whose gts are all ignored
    crowd[2] = True  # an all-crowd item
    valid_d = rng.uniform(size=(b, d)) < 0.85
    valid_g = rng.uniform(size=(b, g)) < 0.9
    ious[3, 2] = -np.inf  # an invalid row of -inf
    valid_d[3, 2] = False
    return ious, crowd, ignored, valid_d, valid_g


CASES = {
    "coco_thresholds": (0, THRS, {}),
    "thr_one_and_above": (1, np.float32([1.0, 0.5, 1.5, 0.0]), {}),
    "no_ties": (2, THRS, {"ties": False}),
    "g_64_more_than_one_gt_a_lane": (3, THRS[:3], {"g": 64, "d": 8}),
    "one_area": (4, THRS, {"a": 1}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matcher_equals_jax(name):
    seed, thrs, shape = CASES[name]
    args = _batch(seed, **shape)
    want = jmatch.match_batch(*map(jnp.asarray, args), jnp.asarray(thrs))
    got = tmatch.match_batch(*map(torch.from_numpy, args), torch.from_numpy(thrs))
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_invalid_detections_leave_the_carry():
    ious, crowd, ignored, valid_d, valid_g = _batch(5)
    valid_d[:] = True
    valid_d[:, ::2] = False
    got = tmatch._match_batch_plain(*map(torch.from_numpy, (ious, crowd, ignored, valid_d, valid_g)),
                                    torch.from_numpy(THRS))
    assert not got[0][..., ::2].any() and not got[1][..., ::2].any()
    # the same items with the invalid rows taken out match alike
    keep = np.arange(ious.shape[1])[1::2]
    dense = tmatch._match_batch_plain(*map(torch.from_numpy, (ious[:, keep], crowd, ignored, valid_d[:, keep], valid_g)),
                                      torch.from_numpy(THRS))
    for g, d in zip(got, dense):
        assert torch.equal(g[..., 1::2], d)


def test_match_batch_padded_equals_jax():
    rng = np.random.default_rng(9)
    items = []
    for i in range(40):
        d, g = int(rng.integers(0, 20)), int(rng.integers(0, 10))
        ious = np.round(rng.uniform(size=(d, g)) * 10).astype(np.float32) / 10
        crowd = rng.uniform(size=g) < 0.2
        items.append((ious, crowd, crowd[None, :] | (rng.uniform(size=(4, g)) < 0.2)))
    want = jmatch.match_batch_padded(items, THRS)
    got = tmatch.match_batch_padded(items, THRS, torch.device("cpu"))
    assert len(got) == len(want) == 40
    for (gm, gi), (wm, wi) in zip(got, want):
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_array_equal(gi, np.asarray(wi))
    assert tmatch.match_batch_padded([], THRS, torch.device("cpu")) == []


def test_launcher_refuses_before_any_launch():
    args = [torch.from_numpy(x) for x in _batch(0)]
    thr = torch.from_numpy(THRS)
    with pytest.raises(ValueError, match="CUDA"):
        kcm.coco_match(*args, thr)  # CPU tensors
    with pytest.raises(ValueError, match="dtype"):
        kcm.coco_match(args[0].double(), *args[1:], thr)
    with pytest.raises(ValueError, match="shape"):
        kcm.coco_match(args[0], args[1][:, :4], *args[2:], thr)
    wide = torch.zeros((1, 4, kcm.MAX_GTS + 1))
    with pytest.raises(ValueError, match="ground truths"):
        kcm.coco_match(wide, torch.zeros((1, kcm.MAX_GTS + 1), dtype=torch.bool),
                       torch.zeros((1, 4, kcm.MAX_GTS + 1), dtype=torch.bool), torch.ones((1, 4), dtype=torch.bool),
                       torch.ones((1, kcm.MAX_GTS + 1), dtype=torch.bool), thr)
    with pytest.raises(ValueError, match="thresholds"):
        kcm.coco_match(*args, torch.zeros(kcm.MAX_THRESHOLDS + 1))
    assert kcm.coco_match.launches == 0
    assert not kcm.coco_match.shapes


@pytest.mark.parametrize("g,k", [(1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (129, 8), (256, 8)])
def test_gts_a_lane(g, k):
    assert kcm.gts_per_lane(g) == k
