"""Parity of the port's segmentation metrics with the JAX package, and the ``segmentation_counts`` kernel's model.

The same seeded numpy label maps (up to 4 x 37 x 41, and 3-D volumes) go
through both packages; the port runs on the CPU, where index maps take the
plain version of the ``segmentation_counts`` kernel, JAX's one-hot form
(``chip_smoke.py`` holds the kernel against it on the card). The maps hold
void 255, negative labels (-1, -C, -C-1, -1000) and labels of C and above:
``jnp.eye(C)[idx]`` wraps a negative index once and clamps the rest to
``[0, C-1]``, and the port counts them the same way.

Tolerances: integer counts and the float32 sample counts equal; scores
within 1e-5 relative and 1e-7 absolute (float32 divisions and sums of at
most a few hundred terms, in another order than XLA's).
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.segmentation as jfs
import torchmetrics_tpu.segmentation as js
import torchmetrics_tpu_torch.functional.segmentation as tfs
import torchmetrics_tpu_torch.segmentation as ts
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.kernels import segmentation as kseg

jmiou = importlib.import_module("torchmetrics_tpu.functional.segmentation.mean_iou")

CPU = {"device": "cpu"}
TOL = (1e-5, 1e-7)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


def _maps(seed, shape, c, dtype=np.int64, agree=0.7, void=0.05, odd=True):
    """Seeded label maps: target uniform over C, void 255 on ``void`` of it; preds equal to the target on
    ``agree`` of the pixels; with ``odd``, negative labels and labels of C and above in both."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, size=shape)
    preds = np.where(rng.random(shape) < agree, target, rng.integers(0, c, size=shape))
    target = np.where(rng.random(shape) < void, 255, target)
    if odd and dtype != np.uint8:
        flat_t, flat_p = target.reshape(-1), preds.reshape(-1)
        for i, value in enumerate([-1, -c, -c - 1, -1000, c, c + 3]):
            flat_t[i::97] = value
            flat_p[i + 11::89] = value
    return preds.astype(dtype), target.astype(dtype)


def _jax_counts(preds, target, c):
    """JAX's three (N, C) counts: its one-hots and spatial sums."""
    p, t = jmiou._to_onehot_format(jnp.asarray(preds), jnp.asarray(target), c, "index")
    axes = tuple(range(2, p.ndim))
    p, t = jnp.asarray(p, bool), jnp.asarray(t, bool)
    return np.stack([np.asarray(jnp.sum(p & t, axis=axes)), np.asarray(jnp.sum(p, axis=axes)),
                     np.asarray(jnp.sum(t, axis=axes))], 1).astype(np.int32)


# ----------------------------------------------------------------- the index rule and the plain counts
def test_class_index_is_jax_eye_rule():
    labels = np.array([255, -1, -4, -5, -100, 3, 4, 0, 2**33 + 2, -(2**33) - 1], np.int64)
    want = np.asarray(jnp.argmax(jnp.eye(4, dtype=jnp.int32)[jnp.asarray(labels)], -1))
    np.testing.assert_array_equal(kseg._class_index(torch.from_numpy(labels), 4).numpy(), want)
    u8 = np.array([0, 3, 4, 200, 255], np.uint8)
    want = np.asarray(jnp.argmax(jnp.eye(4, dtype=jnp.int32)[jnp.asarray(u8)], -1))
    np.testing.assert_array_equal(kseg._class_index(torch.from_numpy(u8), 4).numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
@pytest.mark.parametrize("c", [1, 2, 19, 150, 1000])
def test_plain_counts_against_jax(dtype, c):
    preds, target = _maps(c, (3, 17, 23), c, dtype)
    got = kseg._segmentation_counts_plain(torch.from_numpy(preds), torch.from_numpy(target), c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_counts(preds, target, c))


@pytest.mark.parametrize("shape", [(2, 4, 9, 11), (1, 1), (3, 1, 1), (5,), (0, 6, 6), (2, 0, 3)])
def test_plain_counts_volumes_odd_and_empty(shape):
    preds, target = _maps(1, shape, 5, np.int32, odd=False)
    got = kseg._segmentation_counts_plain(torch.from_numpy(preds), torch.from_numpy(target), 5).numpy()
    assert got.shape == (shape[0], 3, 5)
    if np.prod(shape) > 0:
        np.testing.assert_array_equal(got, _jax_counts(preds, target, 5))
    else:
        assert not got.any()


# ----------------------------------------------------------------- functional
def _fn_cases():
    cases = []
    for fmt in ("index", "one-hot"):
        for include_background in (True, False):
            for per_class in (False, True):
                cases.append({"input_format": fmt, "include_background": include_background, "per_class": per_class})
    return cases


def _inputs(seed, shape, c, fmt, dtype=np.int64):
    preds, target = _maps(seed, shape, c, dtype)
    if fmt == "one-hot":  # in range for a one-hot
        preds, target = np.mod(preds, c), np.mod(target, c)
        eye = np.eye(c, dtype=np.int32)
        return np.moveaxis(eye[preds], -1, 1), np.moveaxis(eye[target], -1, 1)
    return preds, target


@pytest.mark.parametrize("kwargs", _fn_cases(), ids=str)
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 3, 9, 11)])
def test_mean_iou_against_jax(kwargs, shape):
    preds, target = _inputs(2, shape, 7, kwargs["input_format"])
    _close(tfs.mean_iou(torch.from_numpy(preds), torch.from_numpy(target), 7, **kwargs),
           jfs.mean_iou(jnp.asarray(preds), jnp.asarray(target), 7, **kwargs))


@pytest.mark.parametrize("kwargs", _fn_cases(), ids=str)
@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
def test_generalized_dice_against_jax(kwargs, weight_type):
    preds, target = _inputs(3, (4, 13, 15), 9, kwargs["input_format"])
    _close(tfs.generalized_dice_score(torch.from_numpy(preds), torch.from_numpy(target), 9, weight_type=weight_type,
                                      **kwargs),
           jfs.generalized_dice_score(jnp.asarray(preds), jnp.asarray(target), 9, weight_type=weight_type, **kwargs))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64, np.int16])
def test_label_dtypes_against_jax(dtype):
    preds, target = _maps(4, (2, 19, 21), 19, dtype)
    for fn in ("mean_iou", "generalized_dice_score"):
        _close(getattr(tfs, fn)(torch.from_numpy(preds), torch.from_numpy(target), 19, input_format="index"),
               getattr(jfs, fn)(jnp.asarray(preds), jnp.asarray(target), 19, input_format="index"))


def test_void_counts_as_the_last_class():
    """A Cityscapes void pixel (255) at 19 classes is class 18 to JAX, and to the port."""
    target = np.full((1, 4, 4), 255, np.int64)
    preds = np.full((1, 4, 4), 18, np.int64)
    got = tfs.mean_iou(torch.from_numpy(preds), torch.from_numpy(target), 19, input_format="index", per_class=True)
    want = jfs.mean_iou(jnp.asarray(preds), jnp.asarray(target), 19, input_format="index", per_class=True)
    _close(got, want)
    assert float(got[0, 18]) == 1.0


def test_errors_as_jax():
    x = np.zeros((2, 4, 4), np.int64)
    cases = [("mean_iou", (x, x, 0), {}), ("mean_iou", (x, x, 3), {"include_background": 1}),
             ("mean_iou", (x, x, 3), {"per_class": "no"}), ("mean_iou", (x, x, 3), {"input_format": "mask"}),
             ("mean_iou", (x, x[:, :3], 3), {"input_format": "index"}),
             ("generalized_dice_score", (x, x, 3), {"weight_type": "cube"}),
             ("generalized_dice_score", (x[0], x[0], 3), {"input_format": "index"}),
             ("generalized_dice_score", (x, x[:1], 3), {})]
    for fn, (p, t, c), kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(jfs, fn)(jnp.asarray(p), jnp.asarray(t), c, **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tfs, fn)(torch.from_numpy(p), torch.from_numpy(t), c, **kwargs)
        assert str(got.value) == str(want.value), (fn, kwargs)
    with pytest.raises(ValueError, match="integer label maps"):
        tfs.mean_iou(torch.zeros((1, 2, 2)), torch.zeros((1, 2, 2)), 3, input_format="index")


# ----------------------------------------------------------------- classes
CLASSES = {
    "MeanIoU": {"num_classes": 7, "input_format": "index"},
    "MeanIoU-per-class": {"num_classes": 7, "input_format": "index", "per_class": True},
    "MeanIoU-no-background": {"num_classes": 7, "input_format": "index", "include_background": False},
    "MeanIoU-one-hot": {"num_classes": 7, "per_class": True},
    "GeneralizedDiceScore": {"num_classes": 7, "input_format": "index"},
    "GeneralizedDiceScore-per-class": {"num_classes": 7, "input_format": "index", "per_class": True},
    "GeneralizedDiceScore-no-background-square": {"num_classes": 7, "input_format": "index",
                                                  "include_background": False, "weight_type": "square"},
    "GeneralizedDiceScore-simple-one-hot": {"num_classes": 7, "weight_type": "simple"},
}


def _state_np(metric):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
            for k, v in metric.metric_state.items()}


@pytest.mark.parametrize("key", sorted(CLASSES))
def test_classes_update_compute_forward_and_state_from_jax(key):
    name, kwargs = key.split("-")[0], CLASSES[key]
    fmt = kwargs.get("input_format", "one-hot")
    jm, tm = getattr(js, name)(**kwargs), getattr(ts, name)(**kwargs, **CPU)
    batches = [_inputs(40 + b, (2, 15, 17), 7, fmt) for b in range(3)]
    for p, t in batches[:2]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    for leaf, want in _state_np(jm).items():
        got = _np(tm.metric_state[leaf])
        assert got.dtype == want.dtype, leaf
        _close(got, want)
    carried = getattr(ts, name)(**kwargs, **CPU)
    carried._state = state_from_jax(carried, _state_np(jm))
    p, t = batches[2]
    _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    carried.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(tm.compute(), jm.compute())
    _close(carried.compute(), jm.compute())


def test_class_errors_and_pickle():
    for cls, kwargs in [("MeanIoU", {"num_classes": 0}), ("MeanIoU", {"num_classes": 3, "input_format": "x"}),
                        ("GeneralizedDiceScore", {"num_classes": 3, "weight_type": "x"})]:
        with pytest.raises(ValueError) as want:
            getattr(js, cls)(**kwargs)
        with pytest.raises(ValueError) as got:
            getattr(ts, cls)(**kwargs, **CPU)
        assert str(got.value) == str(want.value)
    tm = ts.MeanIoU(num_classes=5, input_format="index", **CPU)
    tm.update(*map(torch.from_numpy, _maps(9, (2, 8, 8), 5)))
    _close(pickle.loads(pickle.dumps(tm)).compute(), tm.compute(), (0.0, 0.0))


# ----------------------------------------------------------------- the kernel: plan, launcher, model
def test_plan():
    cityscapes = kseg.plan(2, 1024 * 2048, 19, 132)  # 528 blocks an image wanted, 4,096 pixels each at least
    assert cityscapes == kseg.Plan(4096, 512, True)
    ade = kseg.plan(16, 512 * 512, 150, 132)
    assert ade.chunks * ade.chunk >= 512 * 512 > (ade.chunks - 1) * ade.chunk and ade.chunks == 64
    assert kseg.plan(1, 1, 5, 132) == kseg.Plan(16, 1, True)
    assert not kseg.plan(1, 100, kseg.SHARED_CLASSES + 1, 132).shared
    for n, pixels in ((1, 10**6), (7, 4097), (3, 33), (65_535, 16)):
        g = kseg.plan(n, pixels, 19, 132)
        assert g.chunk % kseg.CHUNK_ALIGN == 0 and g.chunks * g.chunk >= pixels > (g.chunks - 1) * g.chunk


def test_launcher_refuses_what_it_does_not_take():
    x = torch.zeros((2, 4, 4), dtype=torch.int64)
    for args, msg in [((x.float(), x, 3), "uint8, int32 or int64"), ((x, x.to(torch.int16), 3), "uint8, int32"),
                      ((x, torch.zeros((2, 3, 4), dtype=torch.int64), 3), "one shape"), ((x, x, 0), "1 to"), ((x.transpose(1, 2), x, 3), "contiguous"),
                      ((x, x, 3), "CUDA tensors only")]:
        with pytest.raises(ValueError, match=msg):
            kseg.segmentation_counts(*args)
    assert kseg.segmentation_counts.launches == 0


def _kernel_model(preds: np.ndarray, target: np.ndarray, c: int, sms: int = 132):
    """The kernel's algorithm in numpy: blocks over (chunk, image) by ``plan``; packs of V labels (16 bytes of
    the wider map) where the image and the chunk divide by V, else one label a pack; thread t of a block takes
    packs t, t + 256 (a pair), then t + 512, t + 768, ...; each thread merges runs of one class in registers
    for the intersection, prediction and target counts and adds a run when its class changes; the block's
    3 x C histogram is flushed to the output. Returns the counts and the adds (atomics) the runs made."""
    n_images, pixels = preds.shape[0], int(np.prod(preds.shape[1:]))
    p_flat, t_flat = preds.reshape(n_images, -1), target.reshape(n_images, -1)
    g = kseg.plan(n_images, pixels, c, sms)
    width = 16 // max(preds.dtype.itemsize, target.dtype.itemsize)
    v = width if pixels % width == 0 and g.chunk % width == 0 else 1
    p_cls = kseg._class_index(torch.from_numpy(p_flat), c).numpy()
    t_cls = kseg._class_index(torch.from_numpy(t_flat), c).numpy()
    out = np.zeros((n_images, 3, c), np.int64)
    adds = 0
    for n in range(n_images):
        for k in range(g.chunks):
            begin, end = k * g.chunk, min((k + 1) * g.chunk, pixels)
            n_packs = (end - begin) // v
            hist = np.zeros((3, c), np.int64)
            for t in range(kseg.THREADS):
                runs = [[-1, 0], [-1, 0], [-1, 0]]  # intersection, prediction, target

                def add(which, cls):
                    nonlocal adds
                    run = runs[which]
                    if cls != run[0]:
                        if run[1]:
                            hist[which, run[0]] += run[1]
                            adds += 1
                        run[0], run[1] = cls, 0
                    run[1] += 1

                for j0 in range(t, n_packs, 2 * kseg.THREADS):
                    for j in (j0, j0 + kseg.THREADS):
                        if j >= n_packs:
                            break
                        for q in range(v):
                            e = begin + j * v + q
                            pc, tc = int(p_cls[n, e]), int(t_cls[n, e])
                            add(1, pc)
                            add(2, tc)
                            if pc == tc:
                                add(0, pc)
                for which, (cls, count) in enumerate(runs):
                    if count:
                        hist[which, cls] += count
                        adds += 1
            out[n] += hist
    return out.astype(np.int32), adds


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
@pytest.mark.parametrize("case", ["batch", "odd sizes", "one pixel", "3-D volume", "many classes"])
def test_kernel_model_against_jax(dtype, case):
    shape, c, sms = {"batch": ((2, 64, 80), 19, 4), "odd sizes": ((3, 37, 41), 7, 2), "one pixel": ((2, 1, 1), 3, 1),
                     "3-D volume": ((2, 4, 16, 24), 5, 3), "many classes": ((1, 40, 50), 150, 1)}[case]
    preds, target = _maps(50, shape, c, dtype)
    got, _ = _kernel_model(preds, target, c, sms)
    np.testing.assert_array_equal(got, _jax_counts(preds, target, c))


@pytest.mark.parametrize(("dtype", "share"), [(np.uint8, 1 / 16), (np.int32, 1 / 4), (np.int64, 1 / 2)])
def test_kernel_model_runs_merge_regions_of_one_class(dtype, share):
    """A map of 16 x 16 regions costs at most one add a pack and histogram (16 uint8, 4 int32 or 2 int64
    labels a pack), not one a label: the runs also merge across a thread's packs where the class repeats."""
    preds = np.repeat(np.repeat(np.random.default_rng(3).integers(0, 19, size=(2, 4, 4)), 16, 1), 16, 2)
    preds, target = preds.astype(dtype), preds.astype(dtype)
    got, adds = _kernel_model(preds, target, 19, 2)
    np.testing.assert_array_equal(got, _jax_counts(preds, target, 19))
    assert adds <= share * preds.size * 3, adds
