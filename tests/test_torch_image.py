"""Parity of the port's image signal metrics with the JAX package, and the ``ssim_window`` kernel's plan and model.

The same seeded numpy inputs go through both packages; the port runs on the
CPU, where SSIM is the plain version of the ``ssim_window`` kernel
(``chip_smoke.py`` holds the kernel against it on the card). Images are up
to 3 x 48 x 64: smooth seeded fields with a noisy copy as ``preds``.

Tolerances: PSNR, PSNR-B, total variation, SAM and ERGAS within 1e-6
relative (float32 sums in another order than XLA's); the windowed metrics
(SSIM, MS-SSIM, UQI, RASE, RMSE-SW, SCC, VIF, D-lambda, D-s, QNR) within
1e-5 relative and 1e-6 absolute: their float32 window sums run in another
order than XLA's convolution, and the local variances (sum w x^2 - mu^2)
cancel some of those sums' digits. A full SSIM map is compared within 2e-4
absolute: there that cancellation is not averaged away (on these images
JAX's float32 map lies 2.0e-5 and the port's CPU map 8.6e-5 from a float64
evaluation). The kernel's model (float32 row sums about each window's centre
pixel, double column sums) is held against a float64 evaluation within 1e-5
on the map, on these images and four adversarial ones.
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.image as jfi
import torchmetrics_tpu.image as ji
import torchmetrics_tpu_torch.functional.image as tfi
import torchmetrics_tpu_torch.image as ti
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.kernels import ssim as kss

jssim = importlib.import_module("torchmetrics_tpu.functional.image.ssim")
tssim = importlib.import_module("torchmetrics_tpu_torch.functional.image.ssim")
jhelper = importlib.import_module("torchmetrics_tpu.functional.image.helper")
thelper = importlib.import_module("torchmetrics_tpu_torch.functional.image.helper")

CPU = {"device": "cpu"}
F32 = np.float32
EXACT = (1e-6, 1e-7)
WINDOWED = (1e-5, 1e-6)
MAP = (0.0, 2e-4)  # a full SSIM map, position by position (module docstring)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=WINDOWED):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


def _pair(seed, shape=(2, 3, 48, 64), noise=0.08, low=0.0, high=1.0):
    """A smooth seeded image (a block-upsampled field, lightly blurred) and a noisy copy as ``preds``."""
    rng = np.random.default_rng(seed)
    b, c, h, w = shape[0], shape[1], shape[-2], shape[-1]
    coarse = rng.uniform(size=(*shape[:-2], -(-h // 4), -(-w // 4)))
    target = np.repeat(np.repeat(coarse, 4, -2), 4, -1)[..., :h, :w]
    target = 0.5 * target + 0.25 * (np.roll(target, 1, -1) + np.roll(target, 1, -2))
    target = low + (high - low) * target
    preds = target + noise * (high - low) * rng.normal(size=target.shape)
    return preds.astype(F32), target.astype(F32)


def _t(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


# ----------------------------------------------------------------- helper
@pytest.mark.parametrize("pad,outer", [(0, 1), (1, 0), (3, 1), (4, 0), (9, 1)])
def test_symmetric_pad_against_jax(pad, outer):
    x = np.random.default_rng(1).normal(size=(1, 2, 5, 7)).astype(F32)
    np.testing.assert_array_equal(_np(thelper._symmetric_pad_2d(*_t(x), pad, outer)),
                                  np.asarray(jhelper._symmetric_pad_2d(*_j(x), pad, outer)))


@pytest.mark.parametrize("window", [1, 2, 7, 8])
def test_uniform_filter_and_windows_against_jax(window):
    x = _pair(2)[0]
    _close(thelper._uniform_filter(*_t(x), window), jhelper._uniform_filter(*_j(x), window))
    _close(thelper._gaussian_kernel_2d(3, [11, 7], [1.5, 0.9]), jhelper._gaussian_kernel_2d(3, [11, 7], [1.5, 0.9]),
           EXACT)
    _close(thelper._avg_pool2d(*_t(x[..., :47, :63])), jhelper._avg_pool2d(*_j(x[..., :47, :63])), EXACT)


# ----------------------------------------------------------------- PSNR, PSNR-B, TV
@pytest.mark.parametrize("kwargs", [{}, {"data_range": 1.0}, {"data_range": (0.1, 0.8)}, {"base": 2.0},
                                    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
                                    {"data_range": 1.0, "dim": 1, "reduction": "sum"},
                                    {"data_range": 1.0, "dim": (2, 3), "reduction": "elementwise_mean"}])
def test_psnr_functional(kwargs):
    p, t = _pair(3)
    _close(tfi.peak_signal_noise_ratio(*_t(p, t), **kwargs), jfi.peak_signal_noise_ratio(*_j(p, t), **kwargs), EXACT)


@pytest.mark.parametrize("block_size", [4, 8])
def test_psnrb_functional(block_size):
    p, t = _pair(4, (2, 1, 48, 64))
    _close(tfi.peak_signal_noise_ratio_with_blocked_effect(*_t(p, t), block_size=block_size),
           jfi.peak_signal_noise_ratio_with_blocked_effect(*_j(p, t), block_size=block_size), EXACT)
    _close(tfi.peak_signal_noise_ratio_with_blocked_effect(*_t(3 * p, 3 * t)),
           jfi.peak_signal_noise_ratio_with_blocked_effect(*_j(3 * p, 3 * t)), EXACT)  # data range > 2


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation_and_gradients(reduction):
    p, _ = _pair(5)
    _close(tfi.total_variation(*_t(p), reduction=reduction), jfi.total_variation(*_j(p), reduction=reduction), EXACT)
    for g, w in zip(tfi.image_gradients(*_t(p)), jfi.image_gradients(*_j(p))):
        _close(g, w, EXACT)


def test_psnr_tv_errors_as_jax():
    p, t = _pair(6)
    for fn, args, kwargs, exc in [
        ("peak_signal_noise_ratio", (p, t), {"dim": 1}, ValueError),
        ("peak_signal_noise_ratio", (p, t[..., :-1]), {}, RuntimeError),
        ("peak_signal_noise_ratio_with_blocked_effect", (p, t), {}, ValueError),
        ("total_variation", (p[0],), {}, RuntimeError), ("image_gradients", (p[0],), {}, RuntimeError),
        ("total_variation", (p,), {"reduction": "max"}, ValueError),
    ]:
        with pytest.raises(exc) as want:
            getattr(jfi, fn)(*_j(*args), **kwargs)
        with pytest.raises(exc) as got:
            getattr(tfi, fn)(*_t(*args), **kwargs)
        assert str(got.value) == str(want.value), fn


# ----------------------------------------------------------------- SSIM, MS-SSIM
SSIM_KWARGS = [
    {}, {"data_range": 1.0}, {"data_range": (0.1, 0.9)}, {"gaussian_kernel": False, "kernel_size": 7},
    {"gaussian_kernel": False, "kernel_size": (3, 9)}, {"sigma": 0.5}, {"sigma": (1.0, 2.0)},
    {"reduction": "sum"}, {"reduction": "none"}, {"return_full_image": True},
    {"return_contrast_sensitivity": True, "reduction": None}, {"k1": 0.05, "k2": 0.1, "data_range": 2.0},
]


@pytest.mark.parametrize("kwargs", SSIM_KWARGS, ids=[str(k) for k in SSIM_KWARGS])
def test_ssim_functional(kwargs):
    p, t = _pair(7)
    got = tfi.structural_similarity_index_measure(*_t(p, t), **kwargs)
    want = jfi.structural_similarity_index_measure(*_j(p, t), **kwargs)
    if kwargs.get("return_full_image"):
        _close(got[0], want[0])
        _close(got[1], want[1], MAP)
    else:
        _close(got, want)


@pytest.mark.parametrize("kwargs", [{}, {"gaussian_kernel": False, "kernel_size": 3}, {"data_range": (0.0, 1.0)}])
def test_ssim_volumetric(kwargs):
    kwargs = {"sigma": 0.6, **kwargs}
    p, t = _pair(8, (2, 2, 12, 14, 16))
    _close(tfi.structural_similarity_index_measure(*_t(p, t), **kwargs),
           jfi.structural_similarity_index_measure(*_j(p, t), **kwargs))


def test_ssim_float64_input_takes_the_plain_path():
    p, t = _pair(9)
    got = tfi.structural_similarity_index_measure(*_t(p.astype(np.float64), t.astype(np.float64)), data_range=1.0)
    assert got.dtype == torch.float32  # to_tensor narrows 64-bit inputs as the JAX package runs them
    _close(got, jfi.structural_similarity_index_measure(*_j(p, t), data_range=1.0))


BETAS3 = (0.3, 0.4, 0.3)


@pytest.mark.parametrize("kwargs", [{"betas": BETAS3}, {"betas": BETAS3, "normalize": None},
                                    {"betas": BETAS3, "normalize": "simple"},
                                    {"betas": BETAS3, "reduction": "none", "data_range": 1.0},
                                    {"betas": (0.5, 0.5), "gaussian_kernel": False, "kernel_size": 5,
                                     "reduction": "sum"}])
def test_ms_ssim_functional(kwargs):
    p, t = _pair(10)
    _close(tfi.multiscale_structural_similarity_index_measure(*_t(p, t), **kwargs),
           jfi.multiscale_structural_similarity_index_measure(*_j(p, t), **kwargs))


def test_ms_ssim_volumetric():
    p, t = _pair(11, (1, 2, 16, 16, 16))
    kwargs = {"betas": (0.5, 0.5), "gaussian_kernel": False, "kernel_size": 3}
    _close(tfi.multiscale_structural_similarity_index_measure(*_t(p, t), **kwargs),
           jfi.multiscale_structural_similarity_index_measure(*_j(p, t), **kwargs))


def test_ssim_errors_as_jax():
    p, t = _pair(12, (1, 1, 16, 16))
    cases = [
        ("structural_similarity_index_measure", (p[0], t[0]), {}),
        ("structural_similarity_index_measure", (p, t), {"kernel_size": (11, 11, 11)}),
        ("structural_similarity_index_measure", (p, t), {"sigma": (1.5,)}),
        ("structural_similarity_index_measure", (p, t), {"return_full_image": True,
                                                         "return_contrast_sensitivity": True}),
        ("structural_similarity_index_measure", (p, t), {"gaussian_kernel": False, "kernel_size": 4}),
        ("structural_similarity_index_measure", (p, t), {"sigma": 3.0}),
        ("structural_similarity_index_measure", (p, t), {"sigma": -1.0, "gaussian_kernel": False}),
        ("multiscale_structural_similarity_index_measure", (p, t), {}),
        ("multiscale_structural_similarity_index_measure", (p, t), {"betas": [0.5]}),
        ("multiscale_structural_similarity_index_measure", (p, t), {"normalize": "max"}),
    ]
    for fn, args, kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(jfi, fn)(*_j(*args), **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tfi, fn)(*_t(*args), **kwargs)
        assert str(got.value) == str(want.value), (fn, kwargs)


# ----------------------------------------------------------------- spectral
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_uqi_sam_ergas(reduction):
    p, t = _pair(13, low=0.2)
    per_position = MAP if reduction == "none" else WINDOWED
    _close(tfi.universal_image_quality_index(*_t(p, t), reduction=reduction),
           jfi.universal_image_quality_index(*_j(p, t), reduction=reduction), per_position)
    _close(tfi.universal_image_quality_index(*_t(p, t), kernel_size=(5, 7), sigma=(1.0, 2.0), reduction=reduction),
           jfi.universal_image_quality_index(*_j(p, t), kernel_size=(5, 7), sigma=(1.0, 2.0), reduction=reduction),
           per_position)
    # a pixel's angle within 1e-4 rad: near a cosine of 1 one float32 ulp of it moves arccos by ~1.3e-5
    _close(tfi.spectral_angle_mapper(*_t(p, t), reduction=reduction),
           jfi.spectral_angle_mapper(*_j(p, t), reduction=reduction), (0.0, 1e-4) if reduction == "none" else EXACT)
    _close(tfi.error_relative_global_dimensionless_synthesis(*_t(p, t), ratio=2, reduction=reduction),
           jfi.error_relative_global_dimensionless_synthesis(*_j(p, t), ratio=2, reduction=reduction), EXACT)


@pytest.mark.parametrize("window", [1, 5, 8])
def test_rase_rmse_sw(window):
    p, t = _pair(14, low=0.2)
    _close(tfi.relative_average_spectral_error(*_t(p, t), window_size=window),
           jfi.relative_average_spectral_error(*_j(p, t), window_size=window))
    _close(tfi.root_mean_squared_error_using_sliding_window(*_t(p, t), window_size=window, return_rmse_map=True),
           jfi.root_mean_squared_error_using_sliding_window(*_j(p, t), window_size=window, return_rmse_map=True))


@pytest.mark.parametrize("kwargs", [{}, {"window_size": 3}, {"reduction": "none"},
                                    {"hp_filter": np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], F32)}])
@pytest.mark.parametrize("gray", [False, True])
def test_scc(kwargs, gray):
    p, t = _pair(15)
    if gray:
        p, t = p[:, 0], t[:, 0]
    tk = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    jk = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    _close(tfi.spatial_correlation_coefficient(*_t(p, t), **tk), jfi.spatial_correlation_coefficient(*_j(p, t), **jk))


@pytest.mark.parametrize("sigma_n_sq", [2.0, 0.5])
def test_vif(sigma_n_sq):
    p, t = _pair(16, low=0.0, high=255.0)
    _close(tfi.visual_information_fidelity(*_t(p, t), sigma_n_sq=sigma_n_sq),
           jfi.visual_information_fidelity(*_j(p, t), sigma_n_sq=sigma_n_sq))


@pytest.mark.parametrize("p_norm", [1, 2])
def test_d_lambda(p_norm):
    p, t = _pair(17, (2, 3, 24, 32))
    _close(tfi.spectral_distortion_index(*_t(p, t), p=p_norm), jfi.spectral_distortion_index(*_j(p, t), p=p_norm))
    one = p[:, :1], t[:, :1]
    _close(tfi.spectral_distortion_index(*_t(*one)), jfi.spectral_distortion_index(*_j(*one)))


@pytest.mark.parametrize("with_pan_lr", [False, True])
@pytest.mark.parametrize("norm_order", [1, 2])
def test_d_s_and_qnr(with_pan_lr, norm_order):
    preds, pan = _pair(18, (2, 3, 48, 64))
    ms = _pair(19, (2, 3, 12, 16))[1]
    pan_lr = _pair(20, (2, 3, 12, 16))[1] if with_pan_lr else None
    args_t = _t(preds, ms, pan) + ((torch.from_numpy(pan_lr),) if with_pan_lr else (None,))
    args_j = _j(preds, ms, pan) + ((jnp.asarray(pan_lr),) if with_pan_lr else (None,))
    _close(tfi.spatial_distortion_index(*args_t, norm_order=norm_order),
           jfi.spatial_distortion_index(*args_j, norm_order=norm_order))
    _close(tfi.quality_with_no_reference(*args_t, alpha=0.5, beta=2.0, norm_order=norm_order),
           jfi.quality_with_no_reference(*args_j, alpha=0.5, beta=2.0, norm_order=norm_order))


def test_d_s_resize_is_jax_bilinear():
    import jax

    x = _pair(21, (2, 3, 48, 64))[1]
    want = jax.image.resize(jnp.asarray(x), (2, 3, 12, 16), method="bilinear", antialias=False)
    got = torch.nn.functional.interpolate(torch.from_numpy(x), size=(12, 16), mode="bilinear", align_corners=False,
                                          antialias=False)
    _close(got, want, EXACT)


def test_spectral_errors_as_jax():
    p, t = _pair(22, (1, 3, 16, 16))
    cases = [
        ("universal_image_quality_index", (p, t), {"kernel_size": (11,)}),
        ("universal_image_quality_index", (p, t), {"kernel_size": (4, 4)}),
        ("universal_image_quality_index", (p, t), {"kernel_size": (31, 31)}),
        ("spectral_angle_mapper", (p[:, :1], t[:, :1]), {}),
        ("root_mean_squared_error_using_sliding_window", (p, t), {"window_size": 0}),
        ("root_mean_squared_error_using_sliding_window", (p, t), {"window_size": 40}),
        ("relative_average_spectral_error", (p, t), {"window_size": 1.5}),
        ("spatial_correlation_coefficient", (p, t), {"reduction": "sum"}),
        ("spatial_correlation_coefficient", (p, t), {"window_size": 20}),
        ("visual_information_fidelity", (p, t), {}),
        ("spectral_distortion_index", (p, t), {"p": 0}),
        ("spectral_distortion_index", (p, t[:, :2]), {}),
    ]
    for fn, args, kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(jfi, fn)(*_j(*args), **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tfi, fn)(*_t(*args), **kwargs)
        assert str(got.value) == str(want.value), (fn, kwargs)


# ----------------------------------------------------------------- classes
CLASSES = {
    "PeakSignalNoiseRatio": ({"data_range": 1.0}, EXACT),
    "PeakSignalNoiseRatio-none": ({}, EXACT),
    "PeakSignalNoiseRatio-tuple": ({"data_range": (0.1, 0.9)}, EXACT),
    "PeakSignalNoiseRatio-dim": ({"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, EXACT),
    "StructuralSimilarityIndexMeasure": ({"data_range": 1.0}, WINDOWED),
    "StructuralSimilarityIndexMeasure-none": ({"reduction": "none"}, WINDOWED),
    "StructuralSimilarityIndexMeasure-full": ({"return_full_image": True}, MAP),
    "StructuralSimilarityIndexMeasure-cs": ({"return_contrast_sensitivity": True, "reduction": "sum"}, WINDOWED),
    "MultiScaleStructuralSimilarityIndexMeasure": ({"betas": BETAS3}, WINDOWED),
    "MultiScaleStructuralSimilarityIndexMeasure-none": ({"betas": BETAS3, "reduction": "none"}, WINDOWED),
    "UniversalImageQualityIndex": ({}, WINDOWED),
    "SpectralAngleMapper": ({}, EXACT),
    "ErrorRelativeGlobalDimensionlessSynthesis": ({}, EXACT),
    "RelativeAverageSpectralError": ({}, WINDOWED),
    "RootMeanSquaredErrorUsingSlidingWindow": ({}, WINDOWED),
    "SpatialCorrelationCoefficient": ({}, WINDOWED),
    "SpectralDistortionIndex": ({}, WINDOWED),
    "VisualInformationFidelity": ({}, WINDOWED),
    "TotalVariation": ({}, EXACT),
    "TotalVariation-mean": ({"reduction": "mean"}, EXACT),
    "TotalVariation-none": ({"reduction": "none"}, EXACT),
}


def _class_batches(name, n=3):
    for b in range(n):
        p, t = _pair(30 + b, (2, 3, 48, 64), low=0.2 if "Spectral" in name or "Relative" in name else 0.0)
        if name.startswith("PeakSignalNoiseRatioWith"):
            p, t = p[:, :1], t[:, :1]
        yield (p,) if name.startswith("TotalVariation") else (p, t)


def _state_np(metric):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
            for k, v in metric.metric_state.items()}


@pytest.mark.parametrize("key", sorted(CLASSES))
def test_classes_update_compute_forward_and_state_from_jax(key):
    name = key.split("-")[0]
    kwargs, tol = CLASSES[key]
    jm, tm = getattr(ji, name)(**kwargs), getattr(ti, name)(**kwargs, **CPU)
    batches = list(_class_batches(name))
    for batch in batches[:2]:
        jm.update(*_j(*batch))
        tm.update(*_t(*batch))
    for leaf, want in _state_np(jm).items():
        got = tm.metric_state[leaf]
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert _np(g).dtype == w.dtype, leaf
                _close(g, w, tol)
        else:
            assert _np(got).dtype == want.dtype, leaf
            _close(got, want, tol)
    carried = getattr(ti, name)(**kwargs, **CPU)
    carried._state = state_from_jax(carried, _state_np(jm))
    _close(tm(*_t(*batches[2])), jm(*_j(*batches[2])), tol)
    carried.update(*_t(*batches[2]))
    _close(tm.compute(), jm.compute(), tol)
    _close(carried.compute(), jm.compute(), tol)


def test_psnrb_class():
    jm, tm = ji.PeakSignalNoiseRatioWithBlockedEffect(), ti.PeakSignalNoiseRatioWithBlockedEffect(**CPU)
    for b in range(2):
        p, t = _pair(40 + b, (2, 1, 48, 64))
        jm.update(*_j(p, t))
        tm.update(*_t(p, t))
    _close(tm.compute(), jm.compute(), EXACT)
    carried = ti.PeakSignalNoiseRatioWithBlockedEffect(**CPU)
    _close(carried.compute_state(state_from_jax(carried, _state_np(jm))), jm.compute(), EXACT)


@pytest.mark.parametrize("cls", ["SpatialDistortionIndex", "QualityWithNoReference"])
def test_d_s_qnr_classes(cls):
    jm, tm = getattr(ji, cls)(), getattr(ti, cls)(**CPU)
    for b in range(2):
        preds, pan = _pair(50 + b, (1, 3, 48, 64))
        ms = _pair(60 + b, (1, 3, 12, 16))[1]
        jm.update(jnp.asarray(preds), {"ms": jnp.asarray(ms), "pan": jnp.asarray(pan)})
        tm.update(torch.from_numpy(preds), {"ms": torch.from_numpy(ms), "pan": torch.from_numpy(pan)})
    _close(tm.compute(), jm.compute())
    carried = getattr(ti, cls)(**CPU)
    _close(carried.compute_state(state_from_jax(carried, _state_np(jm))), jm.compute())
    with pytest.raises(ValueError) as want:
        jm.update(jnp.asarray(preds), {"ms": jnp.asarray(ms)})
    with pytest.raises(ValueError) as got:
        tm.update(torch.from_numpy(preds), {"ms": torch.from_numpy(ms)})
    assert str(got.value) == str(want.value)


def test_class_errors_as_jax():
    cases = [("StructuralSimilarityIndexMeasure", {"reduction": "max"}),
             ("MultiScaleStructuralSimilarityIndexMeasure", {"kernel_size": 1.5}),
             ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (1, 2)}),
             ("PeakSignalNoiseRatio", {"dim": 1}), ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 0}),
             ("RelativeAverageSpectralError", {"window_size": 0}), ("SpectralDistortionIndex", {"p": -1}),
             ("VisualInformationFidelity", {"sigma_n_sq": -1.0}), ("TotalVariation", {"reduction": "max"}),
             ("QualityWithNoReference", {"alpha": -1.0})]
    for cls, kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(ji, cls)(**kwargs)
        with pytest.raises(ValueError) as got:
            getattr(ti, cls)(**kwargs, **CPU)
        assert str(got.value) == str(want.value), cls


def test_pickle_and_clone():
    tm = ti.StructuralSimilarityIndexMeasure(data_range=1.0, **CPU)
    tm.update(*_t(*_pair(70)))
    _close(pickle.loads(pickle.dumps(tm)).compute(), tm.compute(), EXACT)
    _close(tm.clone().compute(), tm.compute(), EXACT)


# ----------------------------------------------------------------- the kernel: plan, launcher, model
def test_plan():
    g = kss.plan(4, 3, 1356, 2040, 11, 11, False)  # DIV2K's batch: tiles of 32 x 64 over the interior only
    assert (g.row0, g.col0, g.rows, g.cols) == (5, 5, 1346, 2030)
    assert g.blocks == (64, 22, 12)
    # column taps (double), row taps (float32, even count), two input planes of 74 rows of stride 43, the
    # five float32 row moments in rows of 33: 74,432 bytes, three blocks of 256 threads an SM by shared memory
    assert g.shared_bytes == 8 * 11 + 4 * 12 + 4 * 2 * 74 * 43 + 4 * 5 * 74 * 33 == 74_432
    assert 3 * (g.shared_bytes + 1024) <= 228 * 1024
    full = kss.plan(4, 3, 1356, 2040, 11, 11, True)
    assert (full.row0, full.col0, full.rows, full.cols) == (0, 0, 1356, 2040) and full.blocks == (64, 22, 12)
    assert kss.plan(1, 1, 11, 11, 11, 11, False).blocks == (1, 1, 1)
    assert kss.plan(2, 3, 130, 40, 7, 7, False).blocks == (2, 2, 6)
    widest = kss.plan(1, 1, 63, 63, kss.MAX_TAPS, kss.MAX_TAPS, True)
    assert widest.shared_bytes == 8 * 63 + 4 * 64 + 4 * 2 * 126 * 95 + 4 * 5 * 126 * 33 <= 227 * 1024
    assert kss.plan(1, 1, 20, 20, 1, 11, False).rows == 20  # a pad of 0 keeps no interior: the mean is NaN
    for kh, kw in ((3, 9), (9, 3), (31, 31)):  # the input stride is odd: row-pass reads free of bank conflicts
        assert ((kss.TILE_W + kw - 1) | 1) % 2 == 1 and kss.plan(1, 1, 64, 64, kh, kw, True).shared_bytes <= 227 * 1024


def test_launcher_refuses_what_it_does_not_take():
    x = torch.zeros((1, 1, 16, 16))
    taps, consts = torch.full((11,), 1 / 11, dtype=torch.float64), torch.zeros(2)
    for kwargs, msg in [({"preds": x.double()}, "float32"), ({"target": x[..., :-1]}, "one shape"),
                        ({"taps_h": torch.ones(4)}, "odd number"), ({"taps_w": torch.ones(65)}, "odd number"),
                        ({"taps_w": taps.float()}, "float64"),
                        ({"preds": torch.zeros((1, 1, 8, 8)), "target": torch.zeros((1, 1, 8, 8))}, "smaller"),
                        ({"consts": torch.zeros(3)}, "c1 and c2"), ({}, "CUDA tensors only"),
                        ({"contrast_sensitivity": True, "full_image": True}, "exclusive")]:
        args = {"preds": x, "target": x, "taps_h": taps, "taps_w": taps, "consts": consts, **kwargs}
        with pytest.raises(ValueError, match=msg):
            kss.ssim_window(**args)


def _fma32(a, b, c):
    """float32 fused multiply-add: the product is exact in double, one rounding to float32 (two, rarely)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _reflect(i, n):
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def _kernel_model(p, t, taps_h, taps_w, c1, c2, full=False):
    """numpy model of the kernel: ``kss.plan``'s tiles of TILE_W x TILE_H outputs over the unpadded interior
    (or every position for the map, the border read through the reflected index); a row pass of kw float32
    taps in float32 over x - s, s each row window's centre pixel, its five moments summed tap after tap; a
    column pass in double over each row window's moments rebased about 0 (A + s W, B + s (2 A + s W),
    W the float32 taps' sum) with the column taps divided by W; the map's differences in double, its two
    quotients' terms rounded to float32; the per-image means of ssim and cs: each thread's 8 rows of a
    column summed in float32, those sums in double."""
    b_n, c_n, h, w = p.shape
    th_, tw_ = kss.TILE_H, kss.TILE_W
    kh, kw = len(taps_h), len(taps_w)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    r0, c0 = (0, 0) if full else (ph, pw)
    sums = np.zeros((b_n, 2))
    the_map = np.zeros(p.shape, F32)
    ww = np.asarray(taps_w, np.float64).astype(F32)
    w_sum = ww.astype(np.float64).sum()
    wh = np.asarray(taps_h, np.float64) / w_sum
    c1, c2 = float(c1), float(c2)
    for b in range(b_n):
        for c in range(c_n):
            for oy in range(r0, h - r0, th_):
                for ox in range(c0, w - c0, tw_):
                    ys = _reflect(np.arange(oy - ph, oy + th_ + ph), h)
                    xs = _reflect(np.arange(ox - pw, ox + tw_ + pw), w)
                    x, z = p[b, c][np.ix_(ys, xs)], t[b, c][np.ix_(ys, xs)]
                    sx, sz = x[:, pw:pw + tw_], z[:, pw:pw + tw_]
                    m = [np.zeros((x.shape[0], tw_), F32) for _ in range(5)]
                    for k in range(kw):
                        dx, dz = (x[:, k:k + tw_] - sx).astype(F32), (z[:, k:k + tw_] - sz).astype(F32)
                        wx, wz = (ww[k] * dx).astype(F32), (ww[k] * dz).astype(F32)
                        m[0], m[1] = (m[0] + wx).astype(F32), (m[1] + wz).astype(F32)
                        m[2], m[3], m[4] = _fma32(wx, dx, m[2]), _fma32(wz, dz, m[3]), _fma32(wx, dz, m[4])
                    ap, at, bpp, btt, bpt = (v.astype(np.float64) for v in m)
                    s, u = sx.astype(np.float64), sz.astype(np.float64)
                    r1p, r1t = ap + s * w_sum, at + u * w_sum
                    rows = (r1p, r1t, bpp + s * (ap + r1p), btt + u * (at + r1t), bpt + s * at + u * r1p)
                    mu_p, mu_t, e_pp, e_tt, e_pt = (sum(wh[k] * r[k:k + th_] for k in range(kh)) for r in rows)
                    upper = 2 * (e_pt - mu_p * mu_t) + c2
                    lower = np.maximum(e_pp - mu_p**2, 0) + np.maximum(e_tt - mu_t**2, 0) + c2
                    ssim = ((2 * mu_p * mu_t + c1) * upper).astype(F32) / ((mu_p**2 + mu_t**2 + c1) * lower).astype(F32)
                    cs = upper.astype(F32) / lower.astype(F32)
                    yy, xx = np.meshgrid(np.arange(oy, oy + th_), np.arange(ox, ox + tw_), indexing="ij")
                    inside = (yy < h - r0) & (xx < w - c0)
                    the_map[b, c, yy[inside], xx[inside]] = ssim[inside]
                    valid = inside & (yy >= ph) & (yy < h - ph) & (xx >= pw) & (xx < w - pw)
                    for k, v in enumerate((ssim, cs)):  # a thread's 8 rows of a column in float32, then double
                        strips = np.where(valid, v, F32(0)).reshape(th_ // 8, 8, tw_)
                        acc = np.zeros((th_ // 8, tw_), F32)
                        for j in range(8):
                            acc = (acc + strips[:, j]).astype(F32)
                        sums[b, k] += acc.astype(np.float64).sum()
    count = c_n * (h - 2 * ph) * (w - 2 * pw)
    return (sums[:, 0] / count).astype(F32), (sums[:, 1] / count).astype(F32), the_map


def _float64_ssim(p, t, taps_h, taps_w, c1, c2):
    """A float64 evaluation: reflect padding, the separable window, the map at every position and the
    per-image means of ssim and cs over the interior."""
    b_n, _, h, w = p.shape
    kh, kw = len(taps_h), len(taps_w)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    wh, ww = np.asarray(taps_h, np.float64), np.asarray(taps_w, np.float64)

    def window(a):
        a = np.pad(a, ((0, 0), (0, 0), (ph, ph), (pw, pw)), mode="reflect")
        r = sum(ww[k] * a[..., :, k:k + w] for k in range(kw))
        return sum(wh[k] * r[..., k:k + h, :] for k in range(kh))

    x, z = p.astype(np.float64), t.astype(np.float64)
    mu_p, mu_t, e_pp, e_tt, e_pt = (window(v) for v in (x, z, x * x, z * z, x * z))
    upper = 2 * (e_pt - mu_p * mu_t) + c2
    lower = np.maximum(e_pp - mu_p**2, 0) + np.maximum(e_tt - mu_t**2, 0) + c2
    ssim = ((2 * mu_p * mu_t + c1) * upper) / ((mu_p**2 + mu_t**2 + c1) * lower)
    inner = (slice(None), slice(None), slice(ph, h - ph), slice(pw, w - pw))
    return ssim[inner].reshape(b_n, -1).mean(-1), (upper / lower)[inner].reshape(b_n, -1).mean(-1), ssim


def _adversarial(kind, shape=(2, 3, 80, 96), seed=85):
    """Images where float32 window sums lose digits: values in [100, 101] with light noise, [0, 255] with
    faint noise, a steep ramp across a tile, a step edge next to a flat region."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    if kind == "offset":
        return _pair(seed, shape, noise=0.02, low=100.0, high=101.0)
    if kind == "0-255":
        return _pair(seed, shape, noise=0.002, low=0.0, high=255.0)
    if kind == "ramp":
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        t = np.broadcast_to(((7.3 * xx + 2.1 * yy) % 200) / 200 * 255, shape)
    else:  # "step"
        t = np.zeros(shape)
        t[..., :, w // 2:] = 200.0
        t[..., : h // 3, :] = 37.0
    noise = 0.3 if kind == "ramp" else 0.05
    return (t + noise * rng.normal(size=shape)).astype(F32), t.astype(F32)


@pytest.mark.parametrize("window", ["gaussian 11", "gaussian 5 (sigma 0.5)", "uniform 7", "gaussian 31 (sigma 4.3)"])
@pytest.mark.parametrize("image", ["smooth", "odd sizes", "offset", "0-255", "ramp", "step"])
def test_kernel_model_against_float64(image, window):
    """The kernel's numerics (float32 row pass about each window's centre pixel, double column pass and
    differences) against a float64 evaluation: the full map within 1e-5 absolute and the per-image SSIM
    and CS within 1e-5 relative, on the test images and four adversarial ones (c1, c2 from max - min)."""
    p, t = {"smooth": lambda: _pair(80), "odd sizes": lambda: _pair(81, (2, 3, 37, 75))}.get(
        image, lambda: _adversarial(image))()
    if window == "uniform 7":
        taps = np.full(7, 1 / 7)
    else:
        win, sigma = {"gaussian 11": (11, 1.5), "gaussian 5 (sigma 0.5)": (5, 0.5),
                      "gaussian 31 (sigma 4.3)": (31, 4.3)}[window]
        taps = thelper._gaussian(win, sigma, torch.float64).numpy()
    span = float(max(p.max(), t.max()) - min(p.min(), t.min()))
    c1, c2 = F32((0.01 * span) ** 2), F32((0.03 * span) ** 2)
    want_ssim, want_cs, want_map = _float64_ssim(p, t, taps, taps, float(c1), float(c2))
    _, _, got_map = _kernel_model(p, t, taps, taps, c1, c2, full=True)
    got_ssim, got_cs, _ = _kernel_model(p, t, taps, taps, c1, c2)
    np.testing.assert_allclose(got_map, want_map, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_ssim, want_ssim, rtol=1e-5)
    np.testing.assert_allclose(got_cs, want_cs, rtol=1e-5)


@pytest.mark.parametrize("case", ["gaussian", "uniform", "sigma 0.5", "odd sizes", "full map"])
def test_kernel_model_against_jax(case):
    """The kernel's algorithm (the separable window over the unpadded interior, float32 row sums about each
    window's centre, double column sums) equals JAX's pad, 2-D convolution and crop: per-image SSIM and CS
    within 1e-5 relative, the map within 5e-5 absolute (JAX's float32 map lies 2e-5 from a float64
    evaluation of these inputs)."""
    shape = (2, 3, 37, 75) if case == "odd sizes" else (2, 3, 48, 64)
    p, t = _pair(80, shape)
    sigma = 0.5 if case == "sigma 0.5" else 1.5
    win = int(3.5 * sigma + 0.5) * 2 + 1
    taps = (np.full(7, 1 / 7) if case == "uniform"  # float64, as the kernel takes them
            else thelper._gaussian(win, sigma, torch.float64).numpy())
    c1, c2 = F32(0.01**2), F32(0.03**2)
    got_ssim, got_cs, got_map = _kernel_model(p, t, taps, taps, c1, c2, full=case == "full map")
    kwargs = {"gaussian_kernel": case != "uniform", "sigma": sigma, "kernel_size": 7, "data_range": 1.0}
    want_ssim, want_cs = jssim._ssim_update(*_j(p, t), **kwargs, return_contrast_sensitivity=True)
    np.testing.assert_allclose(got_ssim, np.asarray(want_ssim), rtol=1e-5)
    np.testing.assert_allclose(got_cs, np.asarray(want_cs), rtol=1e-5)
    if case == "full map":
        _, want_map = jssim._ssim_update(*_j(p, t), **kwargs, return_full_image=True)
        np.testing.assert_allclose(got_map, np.asarray(want_map), atol=5e-5)
