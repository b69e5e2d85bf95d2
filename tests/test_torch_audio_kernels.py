"""Float64 models of the audio kernels' algorithms, held against the JAX package and a float64 evaluation.

``snr_moments`` (``csrc/snr_moments.cu``) sums each row's (or each speaker
pair's) moments in float64 and evaluates SNR, SI-SDR and SA-SDR from them in
an expanded form whose noise energy is clamped at 0; ``sdr_toeplitz``
(``csrc/sdr_toeplitz.cu``) solves SDR's Toeplitz system by a Schur-type
(generator) recursion in float64, every vector in registers. Neither runs
here (no ``nvcc``, no card), so the models below follow the kernels step by
step: change them with the kernels. The Levinson recursion (Golub and Van
Loan 4.7.3), the classical form with two dot products a step, is held beside
the Schur-type one on the same cases. ``chip_smoke.py`` holds the kernels
themselves against the plain versions and a float64 evaluation on the card.

Tolerances: the moment model within 1e-4 dB plus 1e-5 relative of JAX's
float32 values, and within 1e-5 dB of the float64 direct form up to 80 dB
(float32's half ulp there is 3.8e-6 dB);
each recursion's solution within 1e-9 relative of a float64 LU (SDR within
1e-6 dB), and its SDR within 1e-3 dB of JAX's float32 LU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.signal
import torch

import torchmetrics_tpu.functional.audio as jf
from torchmetrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr
from torchmetrics_tpu_torch.kernels import sdr_toeplitz as ksdr
from torchmetrics_tpu_torch.kernels import snr_moments as ksnr

EPS = ksnr.EPS


def _ratio_db(stt, spt, spp, scale_invariant):
    """``ratio_db`` of the kernel: the expanded noise energy, clamped at 0 (a NaN stays NaN)."""
    if scale_invariant:
        alpha = (spt + EPS) / (stt + EPS)
        sig = alpha * alpha * stt
        noise = sig - 2.0 * alpha * spt + spp
    else:
        sig = stt
        noise = stt - 2.0 * spt + spp
    noise = np.where(noise < 0.0, 0.0, noise)
    return 10.0 * np.log10((sig + EPS) / (noise + EPS))


def _moments_model(preds, target, scale_invariant, zero_mean, group=1, pairs=False):
    """The kernel's values from float64 sums: rows ``(R, T)`` (a value a group of rows) or pairs ``(B, S, T)``."""
    p, t = preds.astype(np.float64), target.astype(np.float64)
    n = p.shape[-1]
    if pairs:
        spt = np.einsum("bit,bjt->bji", p, t)
        sp, st = p.sum(-1)[:, None, :], t.sum(-1)[:, :, None]
        spp, stt = (p * p).sum(-1)[:, None, :], (t * t).sum(-1)[:, :, None]
    else:
        sp, st, spp, stt, spt = p.sum(-1), t.sum(-1), (p * p).sum(-1), (t * t).sum(-1), (p * t).sum(-1)
    if zero_mean:
        stt, spt, spp = stt - st * st / n, spt - sp * st / n, spp - sp * sp / n
    if not pairs:
        stt, spt, spp = (v.reshape(-1, group).sum(-1) for v in (stt, spt, spp))
    return _ratio_db(stt, spt, spp, scale_invariant).astype(np.float32)


def _direct64(preds, target, scale_invariant, zero_mean):
    """JAX's direct form (the noise, then its energy) in float64, with float32's eps."""
    p, t = preds.astype(np.float64), target.astype(np.float64)
    if zero_mean:
        p, t = p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    if scale_invariant:
        t = ((p * t).sum(-1, keepdims=True) + EPS) / ((t * t).sum(-1, keepdims=True) + EPS) * t
    return 10 * np.log10(((t * t).sum(-1) + EPS) / (((t - p) ** 2).sum(-1) + EPS))


def _signals(seed, shape, snr_db, dc=0.0):
    rng = np.random.default_rng(seed)
    target = scipy.signal.lfilter([1.0], [1.0, -0.9], rng.normal(size=shape), axis=-1)
    noise = rng.normal(size=shape)
    noise *= np.sqrt((target**2).sum(-1, keepdims=True) / (noise**2).sum(-1, keepdims=True)) * 10 ** (-snr_db / 20)
    return (target + noise + dc).astype(np.float32), target.astype(np.float32)


JAX_FORMS = {  # (scale_invariant, zero_mean): JAX's function
    (False, False): lambda p, t: jf.signal_noise_ratio(p, t),
    (False, True): lambda p, t: jf.signal_noise_ratio(p, t, zero_mean=True),
    (True, False): lambda p, t: jf.scale_invariant_signal_distortion_ratio(p, t),
    (True, True): lambda p, t: jf.scale_invariant_signal_noise_ratio(p, t),
}


@pytest.mark.parametrize(("scale_invariant", "zero_mean"), list(JAX_FORMS))
@pytest.mark.parametrize(("shape", "snr_db"), [((6, 8000), 10.0), ((3, 1), 5.0), ((4, 1003), 0.0), ((2, 16000), 30.0)])
def test_moment_model_against_jax(scale_invariant, zero_mean, shape, snr_db):
    preds, target = _signals(1, shape, snr_db, dc=0.2)
    want = np.asarray(JAX_FORMS[(scale_invariant, zero_mean)](jnp.asarray(preds), jnp.asarray(target)))
    got = _moments_model(preds, target, scale_invariant, zero_mean)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(("scale_invariant", "zero_mean"), list(JAX_FORMS))
@pytest.mark.parametrize("snr_db", [0.0, 20.0, 80.0])
def test_moment_model_against_float64_direct(scale_invariant, zero_mean, snr_db):
    """The expanded form loses nothing that float32 output shows, up to inputs 80 dB apart."""
    preds, target = _signals(2, (4, 32000), snr_db, dc=0.01)
    got = _moments_model(preds, target, scale_invariant, zero_mean).astype(np.float64)
    np.testing.assert_allclose(got, _direct64(preds, target, scale_invariant, zero_mean), rtol=0, atol=1e-5)


@pytest.mark.parametrize(("scale_invariant", "zero_mean"), list(JAX_FORMS))
def test_moment_model_identical_inputs_and_zero_target(scale_invariant, zero_mean):
    """Equal inputs: equal sums, a noise of exactly 0, JAX's (S + eps) / eps; an all-zero target: eps / (S + eps)."""
    _, target = _signals(3, (3, 5000), 10.0, dc=0.1)
    t = target.astype(np.float64)
    stt = (t * t).sum(-1) - (t.sum(-1) ** 2 / t.shape[-1] if zero_mean else 0.0)
    exact = (10 * np.log10((stt + EPS) / EPS)).astype(np.float32)  # a noise of exactly 0, alpha exactly 1
    got = _moments_model(target, target, scale_invariant, zero_mean)
    np.testing.assert_array_equal(got, exact)
    want = np.asarray(JAX_FORMS[(scale_invariant, zero_mean)](jnp.asarray(target), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    zero = np.zeros_like(target)
    got = _moments_model(target, zero, scale_invariant, zero_mean)
    want = np.asarray(JAX_FORMS[(scale_invariant, zero_mean)](jnp.asarray(target), jnp.asarray(zero)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_moment_model_groups_are_sa_sdr(scale_invariant, zero_mean):
    preds, target = _signals(4, (3, 2, 4000), 6.0, dc=0.05)
    want = np.asarray(jf.source_aggregated_signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target),
                                                                   scale_invariant, zero_mean))
    got = _moments_model(preds.reshape(6, -1), target.reshape(6, -1), scale_invariant, zero_mean, group=2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("speakers", [1, 2, 3, 6])
@pytest.mark.parametrize(("scale_invariant", "zero_mean"), list(JAX_FORMS))
def test_moment_model_pairs_is_pits_tiled_matrix(speakers, scale_invariant, zero_mean):
    """Pairs mode ``[b, j, i]`` = metric(estimate i, target j): JAX's speaker-wise tile."""
    preds, target = _signals(5, (3, speakers, 2000), 8.0, dc=0.05)
    b, s, n = preds.shape
    p_rep = np.broadcast_to(preds[:, None], (b, s, s, n)).reshape(-1, n)
    t_rep = np.broadcast_to(target[:, :, None], (b, s, s, n)).reshape(-1, n)
    want = np.asarray(JAX_FORMS[(scale_invariant, zero_mean)](jnp.asarray(p_rep), jnp.asarray(t_rep))).reshape(b, s, s)
    got = _moments_model(preds, target, scale_invariant, zero_mean, pairs=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_moments_plain_version_is_jax():
    """The launcher's plain version (the CPU path) against JAX, in rows, groups and pairs."""
    preds, target = _signals(6, (2, 3, 3000), 7.0, dc=0.1)
    p, t = torch.tensor(preds), torch.tensor(target)
    for si, zm in JAX_FORMS:
        want = np.asarray(JAX_FORMS[(si, zm)](jnp.asarray(preds), jnp.asarray(target)))
        got = ksnr._snr_moments_plain(p.reshape(6, -1), t.reshape(6, -1), si, zm).numpy()
        np.testing.assert_allclose(got, want.reshape(-1), rtol=1e-5, atol=1e-4)
        got = ksnr._snr_moments_plain(p, t, si, zm, pairs=True).numpy()
        np.testing.assert_allclose(got, _moments_model(preds, target, si, zm, pairs=True), rtol=1e-5, atol=1e-4)
    want = np.asarray(jf.source_aggregated_signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target)))
    np.testing.assert_allclose(ksnr._snr_moments_plain(p.reshape(6, -1), t.reshape(6, -1), True, False, 3).numpy(),
                               want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(("units", "length"), [(1, 1), (1, 3), (32, 32000), (16, 32000), (1, 9_600_000),
                                               (2048, 8000), (5, 4097), (100_000, 10)])
def test_moments_plan(units, length):
    """Each (group, speakers) the launcher takes: chunks that cover the row, of whole 16-byte loads; a cluster of at
    most ``CLUSTER`` blocks that holds a group's units and all of their chunks, or one block merged by the second
    level past a cluster; a thread's loads of a chunk in one batch unless that overfills the card or a cluster."""
    for group, speakers in ((1, 1), (2, 1), (12, 1), (1, 2), (1, ksnr.MAX_SPEAKERS)):
        if units % group:
            continue
        g = ksnr.plan(units, length, 132, group, speakers)
        assert g.chunk % ksnr.VEC == 0 and 1 <= g.chunks <= ksnr.MAX_CHUNKS
        assert g.chunks * g.chunk >= max(length, 1) and (g.chunks - 1) * g.chunk < max(length, 1)
        assert g.cluster_units * g.cluster_chunks <= ksnr.CLUSTER and g.chunks % g.cluster_chunks == 0
        assert g.cluster_units in (1, group) and units % g.cluster_units == 0
        if g.cluster_units * g.cluster_chunks == group * g.chunks:  # one cluster a group: no second level
            assert g.cluster_units == group
        else:  # a block a cluster, merged by the second level
            assert group * g.chunks > ksnr.CLUSTER and (g.cluster_units, g.cluster_chunks) == (1, 1)
        per_block = ksnr.THREADS * ksnr.VEC * ksnr.row_loads(speakers)
        assert g.chunk >= min(per_block, -(-length // ksnr.VEC) * ksnr.VEC) or g.chunks > 1
        if g.chunks == -(-length // per_block) or length <= per_block:
            assert g.chunk <= max(per_block, ksnr.VEC)  # one batch of loads a thread
        assert units * g.chunks <= max(units, ksnr.BLOCKS_PER_SM * 132 + units) * ksnr.CLUSTER
        assert ksnr.cluster_shape(g.chunks, group) == (g.cluster_units, g.cluster_chunks)
    assert tuple(ksnr.plan(32, 32000, 132)) == (8000, 4, 1, 4)  # the Libri2Mix batch's rows: one cluster a row
    assert tuple(ksnr.plan(16, 32000, 132, 1, 2)) == (4000, 8, 1, 8)  # its PIT pairs
    assert tuple(ksnr.plan(32, 32000, 132, 2)) == (8000, 4, 2, 4)  # its SA-SDR groups: one cluster a group
    assert tuple(ksnr.plan(1, 9_600_000, 132))[1:] == (264, 1, 1)  # a 10-minute clip: the second level


def test_launchers_refuse_cpu_and_bad_inputs():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ksnr.snr_moments(x, x, True, False)
    with pytest.raises(ValueError, match="float32"):
        ksnr.snr_moments(x.double(), x.double(), True, False)
    with pytest.raises(ValueError, match="speakers"):
        ksnr.snr_moments(torch.zeros((1, 7, 8)), torch.zeros((1, 7, 8)), True, False, pairs=True)
    with pytest.raises(ValueError, match="groups"):
        ksnr.snr_moments(torch.zeros((3, 8)), torch.zeros((3, 8)), True, False, group=2)
    with pytest.raises(ValueError, match="CUDA"):
        ksdr.sdr_toeplitz(x, x)
    with pytest.raises(ValueError, match="L from 1"):
        ksdr.sdr_toeplitz(torch.zeros((1, ksdr.MAX_LENGTH + 1)), torch.zeros((1, ksdr.MAX_LENGTH + 1)))
    with pytest.raises(ValueError, match="float32"):
        ksdr.sdr_toeplitz(x.double(), x.double())


# ------------------------------------------------------------------ Toeplitz solves
def _levinson_model(r0, b):
    """The Levinson recursion (Golub and Van Loan 4.7.3 on toeplitz(r0) / r0[0]) in float64: (SDR, x)."""
    r0, b = r0.astype(np.float64), b.astype(np.float64)
    length = r0.shape[0]
    inv_diag = 1.0 / r0[0]
    t = r0 * inv_diag
    x, y = np.zeros(length), np.zeros(length)
    x[0] = b[0] * inv_diag
    alpha, beta = 0.0, 1.0
    if length > 1:
        alpha = -t[1]
        y[0] = alpha
    for k in range(1, length):
        dot1 = np.dot(t[1:k + 1], x[k - 1::-1])
        dot2 = np.dot(t[1:k + 1], y[k - 1::-1])
        beta *= (1.0 - alpha) * (1.0 + alpha)
        inv_beta = 1.0 / beta
        mu = (b[k] * inv_diag - dot1) * inv_beta
        next_alpha = (-t[k + 1] - dot2) * inv_beta if k + 1 < length else 0.0
        old = y[:k].copy()
        x[:k] += mu * old[::-1]
        y[:k] = old + next_alpha * old[::-1]
        x[k], y[k] = mu, next_alpha
        alpha = next_alpha
    coh = np.dot(b, x)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 10.0 * np.log10(coh / (1.0 - coh)), x


def _schur_model(r0, b):
    """The kernel's recursion in float64, in its order: (SDR, x). On T = toeplitz(r0) / r0[0] and c = b / r0[0],
    slot j holds (f, g, x)[j] once step k >= j and (F, G, R)[j] before; step k reads R_k[k] and F_k[k + 1] (mu and
    gamma over beta, whose reciprocal the step before computed from beta_{k+1} = beta_k - beta_k gamma^2), updates
    every slot by the same three multiply-adds from its left neighbour's old g or G, takes the next step's scalars
    from slots k + 1 and k + 2, and turns slot k + 1 from generators into predictors (g_k[k] = 1)."""
    r0, b = r0.astype(np.float64), b.astype(np.float64)
    length = r0.shape[0]
    inv_diag = 1.0 / r0[0]
    a_, b_ = r0 * inv_diag, r0 * inv_diag
    c_ = b * inv_diag
    a_[0], b_[0], c_[0] = 1.0, 1.0, 0.0
    r_k, f_next = b[0] * inv_diag, a_[1] if length > 1 else 0.0
    beta = inv_beta = 1.0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for k in range(length):
            more = k + 1 < length
            mu = r_k * inv_beta
            gamma = -f_next * inv_beta if more else 0.0
            beta -= beta * gamma * gamma
            next_inv_beta = 1.0 / beta
            left = np.concatenate([[0.0], b_[:-1]])
            old_a = a_.copy()
            for lo, hi, sign in ((0, k + 1, 1.0), (k + 1, length, -1.0)):  # predictors, generators
                c_[lo:hi] += sign * mu * b_[lo:hi]
                a_[lo:hi] = old_a[lo:hi] + gamma * left[lo:hi]
                b_[lo:hi] = left[lo:hi] + gamma * old_a[lo:hi]
            if more:  # the next step's scalars, then slot k + 1 turns: f = gamma, g = 1, x = 0
                r_k, f_next = c_[k + 1], a_[k + 2] if k + 2 < length else 0.0
                a_[k + 1], b_[k + 1], c_[k + 1] = gamma, 1.0, 0.0
            inv_beta = next_inv_beta
        coh = np.dot(b, c_)
        return 10.0 * np.log10(coh / (1.0 - coh)), c_


MODELS = {"levinson": _levinson_model, "schur": _schur_model}


def _correlations(kind, length, filter_length, seed, load_diag=None):
    """The port's float32 r_0 and b (its CPU path's FFTs), and the float32 signals they came from."""
    rng = np.random.default_rng(seed)
    if kind == "tone":
        target = np.sin(2 * np.pi * 440 * np.arange(length) / 8000)
    else:
        target = rng.normal(size=length)
        if kind == "lowpass":
            target = scipy.signal.lfilter(*scipy.signal.butter(8, 0.1), target)
    preds = target + 0.3 * rng.normal(size=length) * np.std(target)
    preds, target = preds.astype(np.float32), target.astype(np.float32)
    t, p = torch.tensor(target), torch.tensor(preds)
    t, p = t / t.norm().clamp_min(1e-6), p / p.norm().clamp_min(1e-6)
    r_0, b = _compute_autocorr_crosscorr(t, p, filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[:1] + load_diag, r_0[1:]])
    return r_0.numpy(), b.numpy(), preds, target


CASES = [("white", 8000, 512, None), ("lowpass", 8000, 512, None), ("white", 4000, 300, None), ("white", 2000, 1, None),
         ("lowpass", 6000, 512, 1e-2), ("white", 3000, 2, None), ("white", 16384, 2048, None),
         ("lowpass", 4000, 33, None)]


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize(("kind", "length", "filter_length", "load_diag"), CASES)
def test_levinson_model_against_float64_lu(kind, length, filter_length, load_diag, model):
    r_0, b, _, _ = _correlations(kind, length, filter_length, 10, load_diag)
    sdr, x = MODELS[model](r_0, b)
    matrix = scipy.linalg.toeplitz(r_0.astype(np.float64))
    want = np.linalg.solve(matrix, b.astype(np.float64))
    np.testing.assert_allclose(x, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(x, scipy.linalg.solve_toeplitz(r_0.astype(np.float64), b.astype(np.float64)),
                               rtol=1e-9, atol=1e-9 * np.abs(want).max())
    coh = np.dot(b.astype(np.float64), want)
    np.testing.assert_allclose(sdr, 10 * np.log10(coh / (1 - coh)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize(("kind", "length", "filter_length", "load_diag"), [c for c in CASES if c[2] <= 512])
def test_levinson_model_against_jax(kind, length, filter_length, load_diag, model):
    """The model on the port's correlations against JAX's float32 SDR of the same signals."""
    r_0, b, preds, target = _correlations(kind, length, filter_length, 11, load_diag)
    sdr, _ = MODELS[model](r_0, b)
    want = float(jf.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), filter_length=filter_length,
                                            load_diag=load_diag))
    assert abs(sdr - want) <= 1e-3, (sdr, want)
    plain, _ = ksdr._sdr_toeplitz_plain(torch.tensor(r_0)[None], torch.tensor(b)[None])
    assert abs(float(plain[0]) - want) <= 1e-3


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("load_diag", [None, 1e-6])
def test_levinson_model_on_the_pure_tone(load_diag, model):
    """A pure tone: the Toeplitz matrix of its autocorrelation has a condition number near 5e8 (1.7e8 with
    load_diag 1e-6). The float64 recursion still agrees with a float64 LU to 1e-6 dB; JAX's float32 LU is the one
    that drifts (by about 7e-3 dB here), so it is held within 0.05 dB only."""
    r_0, b, preds, target = _correlations("tone", 8000, 512, 12, load_diag)
    sdr, _ = MODELS[model](r_0, b)
    lu = np.linalg.solve(scipy.linalg.toeplitz(r_0.astype(np.float64)), b.astype(np.float64))
    coh = np.dot(b.astype(np.float64), lu)
    assert abs(sdr - 10 * np.log10(coh / (1 - coh))) <= 1e-6
    want = float(jf.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), load_diag=load_diag))
    assert abs(sdr - want) <= 0.05, (sdr, want)
