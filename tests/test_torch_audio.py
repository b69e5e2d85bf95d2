"""Parity of the port's audio metrics with the JAX package.

The same seeded numpy signals go through both packages; the port runs on
the CPU (``device="cpu"``), where the SNR family takes the plain version of
the ``snr_moments`` kernel and SDR the plain version of ``sdr_toeplitz``,
JAX's forms in float32 (``chip_smoke.py`` holds the kernels against them on
the card; ``tests/test_torch_audio_kernels.py`` holds float64 models of the
kernels' algorithms against JAX).

Tolerances, in dB unless stated:
- the SNR family (SNR, SI-SNR, SI-SDR, SA-SDR, C-SI-SNR, PIT over them):
  within 1e-4 plus 1e-5 relative (float32 sums of up to 8,000 terms in
  another order than XLA's);
- SDR: within 1e-3 (float32 FFTs of 16,384 points and a float32 LU of a
  512 x 512 system, against XLA's);
- STOI and SRMR (float64 on both sides, float32 results): within 2e-6
  relative;
- PIT's permutations equal.
"""

import os
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import torchmetrics_tpu.audio as ja
import torchmetrics_tpu.functional.audio as jf
import torchmetrics_tpu_torch.audio as ta
import torchmetrics_tpu_torch.functional.audio as tf
from torchmetrics_tpu_torch.core.metric import METRIC_BASE_KWARGS
from torchmetrics_tpu_torch.functional.audio import stoi as tstoi
from torchmetrics_tpu_torch.kernels.sdr_toeplitz import sdr_toeplitz
from torchmetrics_tpu_torch.kernels.snr_moments import snr_moments

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from generate_fixtures import stoi_signals  # noqa: E402

CPU = {"device": "cpu"}
SNR_TOL = (1e-5, 1e-4)  # (relative, absolute dB)
SDR_TOL = (0.0, 1e-3)
FLOAT64_TOL = (2e-6, 0.0)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1])


def _signals(seed, shape, snr_db=10.0, dc=0.0):
    """A seeded target of low-passed noise and an estimate ``snr_db`` below it, with a DC offset ``dc``."""
    rng = np.random.default_rng(seed)
    white = rng.normal(size=shape)
    target = scipy.signal.lfilter([1.0], [1.0, -0.9], white, axis=-1)
    noise = rng.normal(size=shape)
    noise *= np.sqrt((target**2).sum(-1, keepdims=True) / (noise**2).sum(-1, keepdims=True)) * 10 ** (-snr_db / 20)
    return (target + noise + dc).astype(np.float32), target.astype(np.float32)


def _both(jfn, tfn, preds, target, **kwargs):
    return jfn(jnp.asarray(preds), jnp.asarray(target), **kwargs), tfn(torch.tensor(preds), torch.tensor(target), **kwargs)


SHAPES = [(4, 8000), (2, 3, 4000), (1000,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio"])
def test_snr_and_si_sdr(name, shape, zero_mean):
    preds, target = _signals(1, shape, dc=0.1)
    want, got = _both(getattr(jf, name), getattr(tf, name), preds, target, zero_mean=zero_mean)
    _close(got, want, SNR_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_si_snr(shape):
    preds, target = _signals(2, shape, dc=0.1)
    want, got = _both(jf.scale_invariant_signal_noise_ratio, tf.scale_invariant_signal_noise_ratio, preds, target)
    _close(got, want, SNR_TOL)


@pytest.mark.parametrize("shape", [(2, 3, 4000), (4, 2, 8000), (3, 1, 500), (2, 500)])
@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sa_sdr(shape, scale_invariant, zero_mean):
    preds, target = _signals(3, shape, snr_db=5.0, dc=0.05)
    want, got = _both(jf.source_aggregated_signal_distortion_ratio, tf.source_aggregated_signal_distortion_ratio,
                      preds, target, scale_invariant=scale_invariant, zero_mean=zero_mean)
    _close(got, want, SNR_TOL)


def test_sa_sdr_needs_speakers():
    with pytest.raises(RuntimeError, match="spk, time"):
        jf.source_aggregated_signal_distortion_ratio(jnp.zeros(10), jnp.zeros(10))
    with pytest.raises(RuntimeError, match="spk, time"):
        tf.source_aggregated_signal_distortion_ratio(torch.zeros(10), torch.zeros(10))


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("form", ["complex", "stacked"])
def test_complex_si_snr(form, zero_mean):
    preds, target = _signals(4, (2, 2, 65, 40, 2), dc=0.02)
    if form == "complex":
        preds, target = (x[..., 0] + 1j * x[..., 1] for x in (preds, target))
        preds, target = preds.astype(np.complex64), target.astype(np.complex64)
    want, got = _both(jf.complex_scale_invariant_signal_noise_ratio, tf.complex_scale_invariant_signal_noise_ratio,
                      preds, target, zero_mean=zero_mean)
    _close(got, want, SNR_TOL)


def test_complex_si_snr_shape_error():
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        jf.complex_scale_invariant_signal_noise_ratio(jnp.zeros((4, 5, 3)), jnp.zeros((4, 5, 3)))
    with pytest.raises(RuntimeError, match="frequency, time, 2"):
        tf.complex_scale_invariant_signal_noise_ratio(torch.zeros((4, 5, 3)), torch.zeros((4, 5, 3)))


def test_identical_inputs_and_zero_target():
    """Equal signals: no noise, JAX's (S + eps) / eps; an all-zero target: JAX's eps / (S + eps)."""
    _, target = _signals(5, (3, 2000))
    for name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio"):
        want, got = _both(getattr(jf, name), getattr(tf, name), target, target)
        _close(got, want, SNR_TOL)
        zero = np.zeros_like(target)
        want, got = _both(getattr(jf, name), getattr(tf, name), target, zero)
        _close(got, want, SNR_TOL)


@pytest.mark.parametrize(("shape", "filter_length"), [((4, 8000), 512), ((2, 3, 2000), 64), ((1000,), 128),
                                                      ((2, 300), 512)])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sdr(shape, filter_length, zero_mean):
    preds, target = _signals(6, shape, dc=0.05)
    want, got = _both(jf.signal_distortion_ratio, tf.signal_distortion_ratio, preds, target,
                      filter_length=filter_length, zero_mean=zero_mean)
    _close(got, want, SDR_TOL)


@pytest.mark.parametrize("load_diag", [None, 1e-6, 1e-2])
def test_sdr_load_diag_and_cg_iter(load_diag):
    preds, target = _signals(7, (3, 4000))
    want, got = _both(jf.signal_distortion_ratio, tf.signal_distortion_ratio, preds, target, load_diag=load_diag,
                      use_cg_iter=10)
    _close(got, want, SDR_TOL)


def test_shape_mismatch_raises():
    a, b = np.zeros((2, 100), np.float32), np.zeros((2, 101), np.float32)
    for fn in (tf.signal_noise_ratio, tf.scale_invariant_signal_distortion_ratio, tf.signal_distortion_ratio,
               tf.scale_invariant_signal_noise_ratio):
        with pytest.raises(RuntimeError, match="same shape"):
            fn(torch.tensor(a), torch.tensor(b))


def test_cpu_never_launches_and_grad_flows():
    """On the CPU the kernels' plain versions run (no launch); an input that requires grad differentiates."""
    preds, target = _signals(8, (2, 2, 1000))
    before = (snr_moments.launches, sdr_toeplitz.launches)
    p = torch.tensor(preds, requires_grad=True)
    value = tf.scale_invariant_signal_noise_ratio(p, torch.tensor(target)).sum()
    value = value + tf.signal_distortion_ratio(p, torch.tensor(target), filter_length=32).sum()
    value = value + tf.permutation_invariant_training(p, torch.tensor(target), tf.signal_noise_ratio)[0].sum()
    value.backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
    assert (snr_moments.launches, sdr_toeplitz.launches) == before


def test_float64_and_half_tensors_keep_their_dtype():
    """A float64 tensor stays float64 (eps of float64, the port's own path); an array-like beside a tensor is
    narrowed as JAX narrows it."""
    preds, target = _signals(9, (2, 500))
    got = tf.signal_noise_ratio(torch.tensor(preds, dtype=torch.float64), torch.tensor(target, dtype=torch.float64))
    assert got.dtype == torch.float64
    want = jf.signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target))
    _close(got, want, SNR_TOL)
    assert tf.signal_noise_ratio(torch.tensor(preds), target.astype(np.float64)).dtype == torch.float32
    half = tf.signal_noise_ratio(torch.tensor(preds, dtype=torch.bfloat16), torch.tensor(target, dtype=torch.bfloat16))
    assert half.dtype == torch.bfloat16 and torch.isfinite(half).all()


# ------------------------------------------------------------------ PIT
PIT_FUNCS = ["signal_noise_ratio", "scale_invariant_signal_noise_ratio", "scale_invariant_signal_distortion_ratio"]


def _pit_inputs(seed, batch, spk, length, swap_share=0.5):
    """Speakers permuted at random in about ``swap_share`` of the items, then a noisy estimate."""
    rng = np.random.default_rng(seed)
    preds, target = _signals(seed, (batch, spk, length), snr_db=8.0)
    for b in range(batch):
        if rng.random() < swap_share:
            preds[b] = preds[b, rng.permutation(spk)]
    return preds, target


@pytest.mark.parametrize("spk", [2, 3, 4])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("name", PIT_FUNCS)
def test_pit(spk, mode, eval_func, name):
    preds, target = _pit_inputs(10 + spk, 5, spk, 1000)
    j_metric, j_perm = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), getattr(jf, name),
                                                         mode, eval_func)
    t_metric, t_perm = tf.permutation_invariant_training(torch.tensor(preds), torch.tensor(target),
                                                         getattr(tf, name), mode, eval_func)
    assert t_perm.dtype == torch.int32
    np.testing.assert_array_equal(t_perm.numpy(), np.asarray(j_perm))
    _close(t_metric, j_metric, SNR_TOL)
    np.testing.assert_array_equal(tf.pit_permutate(torch.tensor(preds), t_perm).numpy(),
                                  np.asarray(jf.pit_permutate(jnp.asarray(preds), j_perm)))


@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
def test_pit_with_kwargs_and_sdr(mode):
    preds, target = _pit_inputs(20, 3, 2, 2000)
    kw = {"zero_mean": True}
    j = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jf.signal_noise_ratio, mode, **kw)
    t = tf.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), tf.signal_noise_ratio, mode, **kw)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    _close(t[0], j[0], SNR_TOL)
    j = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jf.signal_distortion_ratio, mode,
                                          filter_length=64)
    t = tf.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), tf.signal_distortion_ratio, mode,
                                          filter_length=64)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    _close(t[0], j[0], SDR_TOL)


def test_pit_ties_go_to_the_first_permutation():
    target = np.ones((2, 3, 16), np.float32)
    preds = np.ones((2, 3, 16), np.float32)
    for eval_func in ("max", "min"):
        j = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jf.signal_noise_ratio,
                                              eval_func=eval_func)
        t = tf.permutation_invariant_training(torch.tensor(preds), torch.tensor(target), tf.signal_noise_ratio,
                                              eval_func=eval_func)
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(t[1].numpy(), [[0, 1, 2], [0, 1, 2]])


def test_pit_errors():
    a = torch.zeros((2, 2, 10))
    with pytest.raises(RuntimeError, match="batch and speaker"):
        tf.permutation_invariant_training(a, torch.zeros((2, 3, 10)), tf.signal_noise_ratio)
    with pytest.raises(ValueError, match="eval_func"):
        tf.permutation_invariant_training(a, a, tf.signal_noise_ratio, eval_func="mean")
    with pytest.raises(ValueError, match="mode"):
        tf.permutation_invariant_training(a, a, tf.signal_noise_ratio, mode="pairs")
    with pytest.raises(ValueError, match="batch, spk"):
        tf.permutation_invariant_training(torch.zeros(4), torch.zeros(4), tf.signal_noise_ratio)


def test_pit_class_splits_its_kwargs():
    assert {"device", "compute_with_cache", "sync_on_compute"} <= METRIC_BASE_KWARGS
    preds, target = _pit_inputs(21, 4, 2, 800)
    metric = ta.PermutationInvariantTraining(tf.signal_noise_ratio, zero_mean=True, compute_with_cache=False, **CPU)
    ref = ja.PermutationInvariantTraining(jf.signal_noise_ratio, zero_mean=True)
    assert metric.metric_kwargs == {"zero_mean": True} and metric.device == torch.device("cpu")
    assert not metric.compute_with_cache
    for i in range(3):
        metric.update(torch.tensor(preds[i:i + 2]), torch.tensor(target[i:i + 2]))
        ref.update(jnp.asarray(preds[i:i + 2]), jnp.asarray(target[i:i + 2]))
    _close(metric.compute(), ref.compute(), SNR_TOL)
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        ta.PermutationInvariantTraining(tf.signal_noise_ratio, jit=True, **CPU)


# ------------------------------------------------------------------ classes over three updates
def _class_cases():
    speech = (3, 2, 4000)
    return [
        ("SignalNoiseRatio", {"zero_mean": True}, speech),
        ("SignalNoiseRatio", {}, (3, 4000)),
        ("ScaleInvariantSignalNoiseRatio", {}, speech),
        ("ScaleInvariantSignalDistortionRatio", {"zero_mean": False}, speech),
        ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": False}, speech),
        ("SourceAggregatedSignalDistortionRatio", {}, speech),
        ("SignalDistortionRatio", {"filter_length": 128}, speech),
        ("ComplexScaleInvariantSignalNoiseRatio", {"zero_mean": True}, (3, 2, 33, 20, 2)),
    ]


@pytest.mark.parametrize(("name", "kwargs", "shape"), _class_cases(), ids=lambda v: v if isinstance(v, str) else None)
def test_classes_over_three_updates(name, kwargs, shape):
    jm, tm = getattr(ja, name)(**kwargs), getattr(ta, name)(**kwargs, **CPU)
    for i in range(3):
        preds, target = _signals(30 + i, shape, snr_db=4.0 + 3 * i, dc=0.03)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.tensor(preds), torch.tensor(target))
    tol = SDR_TOL if name == "SignalDistortionRatio" else SNR_TOL
    _close(tm.compute(), jm.compute(), tol)
    assert tm.metric_state["sum_value"].dtype == torch.float32 and tm.metric_state["total"].dtype == torch.float32
    assert float(tm.metric_state["total"]) == float(jm.metric_state["total"])


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_class(extended):
    jm = ja.ShortTimeObjectiveIntelligibility(fs=16000, extended=extended)
    tm = ta.ShortTimeObjectiveIntelligibility(fs=16000, extended=extended, **CPU)
    for i in range(3):
        preds, target = _signals(40 + i, (2, 16000), snr_db=5.0 * i)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.tensor(preds), torch.tensor(target))
    _close(tm.compute(), jm.compute(), FLOAT64_TOL)


def test_srmr_class_takes_preds_only():
    jm = ja.SpeechReverberationModulationEnergyRatio(fs=8000)
    tm = ta.SpeechReverberationModulationEnergyRatio(fs=8000, **CPU)
    for i in range(3):
        preds, _ = _signals(50 + i, (2, 8000))
        jm.update(jnp.asarray(preds))
        tm.update(torch.tensor(preds))
    _close(tm.compute(), jm.compute(), FLOAT64_TOL)
    with pytest.raises(ValueError, match="fs"):
        ta.SpeechReverberationModulationEnergyRatio(fs=44100, **CPU)


def test_pesq_class_with_a_backend():
    backend = lambda fs, t, p, mode: float(np.mean(np.abs(t - p)))  # noqa: E731
    jm = ja.PerceptualEvaluationSpeechQuality(fs=16000, mode="wb", backend=backend)
    tm = ta.PerceptualEvaluationSpeechQuality(fs=16000, mode="wb", backend=backend, **CPU)
    for i in range(3):
        preds, target = _signals(60 + i, (2, 3, 1600))
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.tensor(preds), torch.tensor(target))
    _close(tm.compute(), jm.compute(), (1e-6, 0.0))
    with pytest.raises(ValueError, match="mode"):
        ta.PerceptualEvaluationSpeechQuality(fs=16000, mode="xx", **CPU)


def test_class_arguments_are_checked_as_in_jax():
    for jcls, tcls, kwargs in ((ja.ComplexScaleInvariantSignalNoiseRatio, ta.ComplexScaleInvariantSignalNoiseRatio,
                                {"zero_mean": 1}),
                               (ja.SourceAggregatedSignalDistortionRatio, ta.SourceAggregatedSignalDistortionRatio,
                                {"scale_invariant": "yes"})):
        with pytest.raises(ValueError):
            jcls(**kwargs)
        with pytest.raises(ValueError):
            tcls(**kwargs, **CPU)


# ------------------------------------------------------------------ PESQ
def test_pesq_errors_and_backend():
    sig = np.zeros((2, 16000), np.float32)
    for fs, mode, match in ((44100, "wb", "fs"), (16000, "ab", "mode"), (8000, "wb", "wide band")):
        with pytest.raises(ValueError, match=match):
            tf.perceptual_evaluation_speech_quality(torch.tensor(sig), torch.tensor(sig), fs, mode)
    if not tf.pesq._PESQ_AVAILABLE:
        with pytest.raises(ModuleNotFoundError, match="pesq"):
            tf.perceptual_evaluation_speech_quality(torch.tensor(sig), torch.tensor(sig), 16000, "wb")
    calls = []

    def backend(fs, t, p, mode):
        calls.append((fs, t.dtype, t.shape, mode))
        return 1.5 + float(t.sum() - p.sum())

    preds, target = _signals(70, (2, 3, 800))
    want, got = _both(jf.perceptual_evaluation_speech_quality, tf.perceptual_evaluation_speech_quality, preds, target,
                      fs=8000, mode="nb", backend=backend)
    _close(got, want, (1e-6, 0.0))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    assert calls[0] == (8000, np.float32, (800,), "nb") and len(calls) == 12
    one = tf.perceptual_evaluation_speech_quality(torch.tensor(preds[0, 0]), torch.tensor(target[0, 0]), 8000, "nb",
                                                  backend=backend)
    assert one.shape == ()
    with pytest.raises(RuntimeError, match="same shape"):
        tf.perceptual_evaluation_speech_quality(torch.zeros(10), torch.zeros(11), 8000, "nb", backend=backend)


# ------------------------------------------------------------------ STOI
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_on_the_fixture_signals(fs, extended):
    """The recorded fixtures' three degraded signals, taken at each rate (8 kHz and 16 kHz resample)."""
    cases = stoi_signals()
    preds = np.stack([c["degraded"] for c in cases.values()]).astype(np.float32)
    target = np.stack([c["clean"] for c in cases.values()]).astype(np.float32)
    want, got = _both(jf.short_time_objective_intelligibility, tf.short_time_objective_intelligibility, preds, target,
                      fs=fs, extended=extended)
    _close(got, want, FLOAT64_TOL)
    one = tf.short_time_objective_intelligibility(torch.tensor(preds[0]), torch.tensor(target[0]), fs=fs,
                                                  extended=extended)
    assert one.shape == () and float(one) == pytest.approx(float(got[0]), rel=1e-6)


def test_stoi_silent_gaps():
    """Speech-like bursts with silent gaps: silent-frame removal drops frames, and both packages drop the same."""
    rng = np.random.default_rng(80)
    fs = 16000
    t = np.arange(2 * fs) / fs
    envelope = (np.sin(2 * np.pi * 3 * t) > 0.2).astype(np.float64) * (1 + 0.5 * np.sin(2 * np.pi * 5 * t))
    clean = rng.normal(size=(3, 2 * fs)) * envelope
    noisy = clean + 0.2 * rng.normal(size=clean.shape) * np.array([[0.1], [1.0], [3.0]])
    want, got = _both(jf.short_time_objective_intelligibility, tf.short_time_objective_intelligibility,
                      noisy.astype(np.float32), clean.astype(np.float32), fs=fs)
    _close(got, want, FLOAT64_TOL)


@pytest.mark.parametrize("length", [200, 1500])
def test_stoi_too_short_floor(length):
    """A clip with too few non-silent frames (or segments) scores 1e-5 with JAX's warning."""
    preds, target = _signals(81, (2, length))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tf.short_time_objective_intelligibility(torch.tensor(preds), torch.tensor(target), fs=10000)
    want = jf.short_time_objective_intelligibility(jnp.asarray(preds), jnp.asarray(target), fs=10000)
    _close(got, want, FLOAT64_TOL)
    np.testing.assert_allclose(got.numpy(), 1e-5, rtol=1e-6)
    assert any("intelligibility" in str(w.message) for w in caught)


def test_stoi_shape_mismatch():
    with pytest.raises(RuntimeError, match="same shape"):
        tf.short_time_objective_intelligibility(torch.zeros(16000), torch.zeros(16001), fs=16000)


@pytest.mark.parametrize(("fs_in", "fs_out", "n"), [(16000, 10000, 16000), (8000, 10000, 8001), (16000, 10000, 777),
                                                    (22050, 10000, 5000), (10000, 16000, 3)])
def test_resampler_is_resample_poly(fs_in, fs_out, n):
    """The device polyphase FIR against ``scipy.signal.resample_poly``: same length, values within 1e-12."""
    x = np.random.default_rng(82).normal(size=(2, n))
    got = tstoi._resample(torch.tensor(x), fs_in, fs_out).numpy()
    g = np.gcd(fs_in, fs_out)
    want = scipy.signal.resample_poly(x, fs_out // g, fs_in // g, axis=-1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(x).max())


# ------------------------------------------------------------------ SRMR
@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("norm", [False, True])
def test_srmr(fs, norm):
    preds, _ = _signals(90 + fs // 8000, (2, 2, fs))
    want = jf.speech_reverberation_modulation_energy_ratio(jnp.asarray(preds), fs, norm=norm)
    got = tf.speech_reverberation_modulation_energy_ratio(torch.tensor(preds), fs, norm=norm)
    _close(got, want, FLOAT64_TOL)


@pytest.mark.parametrize("length", [1000, 3001])
def test_srmr_short_signal_pad_and_one_signal(length):
    preds, _ = _signals(95, (length,))
    want = jf.speech_reverberation_modulation_energy_ratio(jnp.asarray(preds), 16000)
    got = tf.speech_reverberation_modulation_energy_ratio(torch.tensor(preds), 16000)
    assert got.shape == ()
    _close(got, want, FLOAT64_TOL)


def test_srmr_arguments():
    with pytest.raises(NotImplementedError, match="fast"):
        tf.speech_reverberation_modulation_energy_ratio(torch.zeros(8000), 8000, fast=True)
    with pytest.raises(ValueError, match="fs"):
        tf.speech_reverberation_modulation_energy_ratio(torch.zeros(8000), 22050)


# ---------------------------------------------------------------- silent targets and empty batches


def _silent_rows(scale=None):
    """Three seeded rows with row 1 silent; with ``scale``, row 0's target that large (its float32 norm
    overflows at 1e20: the row normalises to zero, silent too)."""
    preds, target = _signals(70, (3, 4000))
    target[1] = 0.0
    if scale is not None:
        target[0] *= scale
    return preds, target


@pytest.mark.parametrize("scale", [None, 1e20], ids=["silent", "silent-and-overflowing"])
def test_sdr_silent_target_is_nan_as_in_jax(scale):
    """A silent target makes SDR's Toeplitz system singular: NaN in its row, as ``jnp.linalg.solve`` gives,
    and no ``LinAlgError``."""
    preds, target = _silent_rows(scale)
    j, t = _both(jf.signal_distortion_ratio, tf.signal_distortion_ratio, preds, target)
    assert np.array_equal(np.isnan(_np(t)), np.isnan(np.asarray(j))) and np.isnan(_np(t)[1])
    _close(t, j, SDR_TOL)


def test_sdr_class_with_a_silent_target():
    preds, target = _silent_rows()
    jm, tm = ja.SignalDistortionRatio(), ta.SignalDistortionRatio(**CPU)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.tensor(preds), torch.tensor(target))
    for name in ("sum_value", "total"):
        _close(tm.metric_state[name], jm.metric_state[name], SDR_TOL)
    assert np.isnan(float(tm.compute())) and np.isnan(float(jm.compute()))


def test_pit_sdr_with_a_silent_speaker():
    preds, target = _pit_inputs(71, 2, 2, 2000)
    target[0, 1] = 0.0
    j_metric, j_perm = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target),
                                                         jf.signal_distortion_ratio, "speaker-wise")
    t_metric, t_perm = tf.permutation_invariant_training(torch.tensor(preds), torch.tensor(target),
                                                         tf.signal_distortion_ratio, "speaker-wise")
    assert np.isnan(np.asarray(j_metric)[0]) and np.isnan(_np(t_metric)[0])
    _close(t_metric, j_metric, SDR_TOL)
    np.testing.assert_array_equal(t_perm.numpy()[1], np.asarray(j_perm)[1])


@pytest.mark.parametrize("shape", [(0, 1000), (0, 2, 1000)])
def test_sdr_empty_batch(shape):
    preds = np.zeros(shape, np.float32)
    j, t = _both(jf.signal_distortion_ratio, tf.signal_distortion_ratio, preds, preds)
    assert t.dtype == torch.float32 and tuple(t.shape) == np.asarray(j).shape == shape[:-1]
    jm, tm = ja.SignalDistortionRatio(), ta.SignalDistortionRatio(**CPU)
    jm.update(jnp.asarray(preds), jnp.asarray(preds))
    tm.update(torch.tensor(preds), torch.tensor(preds))
    for name in ("sum_value", "total"):
        _close(tm.metric_state[name], jm.metric_state[name], (0.0, 0.0))
    assert np.isnan(float(tm.compute())) and np.isnan(float(jm.compute()))


def test_stoi_empty_batch():
    preds = np.zeros((0, 8000), np.float32)
    j = jf.short_time_objective_intelligibility(jnp.asarray(preds), jnp.asarray(preds), fs=8000)
    t = tf.short_time_objective_intelligibility(torch.tensor(preds), torch.tensor(preds), fs=8000)
    assert t.dtype == torch.float32 and tuple(t.shape) == np.asarray(j).shape == (0,)
    jm, tm = ja.ShortTimeObjectiveIntelligibility(fs=8000), ta.ShortTimeObjectiveIntelligibility(fs=8000, **CPU)
    jm.update(jnp.asarray(preds), jnp.asarray(preds))
    tm.update(torch.tensor(preds), torch.tensor(preds))
    for name in ("sum_value", "total"):
        _close(tm.metric_state[name], jm.metric_state[name], (0.0, 0.0))
    assert np.isnan(float(tm.compute())) and np.isnan(float(jm.compute()))
