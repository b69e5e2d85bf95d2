"""The COCO matcher: its plain PyTorch version against the JAX ``match_batch``, and the kernel's launcher.

The CUDA kernel (``csrc/coco_match.cu``) runs only on the card, where
``chip_smoke.py`` holds it equal (``torch.equal``) to the plain version;
here the plain version must equal JAX's matcher exactly (both are boolean
maps) on padded items with tied IoUs, crowd and ignored ground truths,
IoUs of exactly 1.0 at ``thr=1.0``, invalid and all ``-inf`` detection rows,
gaps in the valid detections, items of other live extents or none, and G
from 1 to 64; the launch plan must fit the card, and the launcher must refuse what the kernel does not take, before any
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


def _batch(seed, b=6, d=16, g=8, a=4, ties=True, live=None):
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
    if live == "gaps":  # a run of invalid rows, then live rows after it, in every item
        valid_d[:, d // 4 : d // 2] = False
        valid_d[:, -1] = True
    elif live == "extents":  # live prefixes of other lengths, one item with no valid row
        valid_d &= np.arange(d)[None, :] < rng.integers(1, d + 1, (b, 1))
        valid_d[b - 1] = False
    return ious, crowd, ignored, valid_d, valid_g


CASES = {
    "coco_thresholds": (0, THRS, {}),
    "thr_one_and_above": (1, np.float32([1.0, 0.5, 1.5, 0.0]), {}),
    "no_ties": (2, THRS, {"ties": False}),
    "g_64_more_than_one_gt_a_lane": (3, THRS[:3], {"g": 64, "d": 8}),
    "one_area": (4, THRS, {"a": 1}),
    "gaps_in_valid_detections": (6, THRS, {"live": "gaps"}),
    "live_extents_differ_and_an_empty_item": (7, THRS, {"live": "extents"}),
    "g_1": (8, THRS, {"g": 1, "live": "extents"}),
    "g_2": (10, THRS, {"g": 2}),
    "g_16": (11, THRS, {"g": 16, "live": "gaps"}),
    "g_33": (12, THRS[:4], {"g": 33, "d": 12, "live": "extents"}),
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
    lanes, kpl = kcm.lane_group(g)
    assert kpl == k and lanes * kpl >= g
    assert lanes == 32 or kpl == 1


@pytest.mark.parametrize("g,p", [(1, 8), (2, 8), (4, 8), (5, 8), (8, 8), (9, 16), (17, 32), (32, 32)])
def test_lane_group_is_the_next_power_of_two_from_8(g, p):
    assert kcm.lane_group(g) == (p, 1)


PLANS = {  # (D, G, A, T) -> (lanes, gts a lane, scans a block, blocks an item, threads, staged, shared bytes)
    "map_chunk": ((64, 8, 4, 10), (8, 1, 20, 2, 160, True, 2136)),
    "g_32": ((128, 32, 4, 10), (32, 1, 8, 5, 256, True, 16536)),
    "g_1_in_a_group_of_8": ((64, 1, 4, 10), (8, 1, 20, 2, 160, True, 344)),
    "g_256_tile_in_device_memory": ((128, 256, 4, 10), (32, 8, 8, 5, 256, False, 320)),
    "g_64_t_32": ((128, 64, 4, 32), (32, 2, 8, 16, 256, True, 32944)),
    "g_16_t_8_one_block_an_item": ((8, 16, 2, 8), (16, 1, 16, 1, 256, True, 536)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_launch_plan(name):
    (d, g, a, t), want = PLANS[name]
    plan = kcm.launch_plan(d, g, a, t)
    assert tuple(plan) == want
    assert plan.scans_per_block * plan.blocks_per_item >= a * t > plan.scans_per_block * (plan.blocks_per_item - 1)
    assert plan.threads <= kcm.MAX_THREADS and plan.shared_bytes <= kcm.MAX_SHARED_BYTES


def test_launch_plan_refuses_what_shared_memory_cannot_hold():
    assert kcm.launch_plan(200_000, 8, 4, 10).shared_bytes == 200_000 + 4 * 6  # valid_d bytes and the gt masks
    with pytest.raises(ValueError, match="shared memory"):
        kcm.launch_plan(kcm.MAX_SHARED_BYTES, 8, 4, 10)
