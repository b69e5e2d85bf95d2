"""The port's generative image metrics and their backbones, held against the JAX package's.

Both packages run on the same weights (the JAX params, drawn here with
numpy, carried over by ``convert``) and the same seeded inputs. Tolerances:
backbone features within 1e-4 of each tap's largest magnitude (float32
convolutions of XLA and ATen); the resizes within 1e-5 absolute on [-1, 1]
images; FID within 1e-6 relative of the JAX package's float64 value on
full-rank covariances and within 1e-8 (tr S1 + tr S2) on rank-deficient
ones (the square roots of eigenvalues that are zero up to rounding); KID's
and ``poly_mmd``'s MMD^2 within 1e-5 of the terms' scale
``(|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2`` (the MMD cancels);
IS, MiFID, LPIPS and PPL's distances within 1e-5 relative; PPL's discard
within 1e-6 relative; uint8 casts of [0, 1] images equal.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torchmetrics_tpu.functional.image.generative as jgen
import torchmetrics_tpu.image.generative as jimg
from torchmetrics_tpu.functional.image import lpips as jlp
from torchmetrics_tpu.image.backbones import inception as jinc
from torchmetrics_tpu.image.backbones import lpips_nets as jnets
import torchmetrics_tpu_torch.functional.image.generative as tgen
import torchmetrics_tpu_torch.image.generative as timg
from torchmetrics_tpu_torch import convert
from torchmetrics_tpu_torch.image.backbones import inception as tinc
from torchmetrics_tpu_torch.image.backbones import lpips_nets as tnets
from torchmetrics_tpu_torch.kernels import poly_mmd as kpm

# the port's functional image namespace exports the function under the module's name
tlp = importlib.import_module("torchmetrics_tpu_torch.functional.image.lpips")

TAPS = ("64", "192", "768", "pool", "logits", "logits_unbiased")


def _close_to_scale(got, want, tol, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    np.testing.assert_array_less(np.abs(got - want), tol * np.abs(want).max() + 1e-30, err_msg=err_msg)


# ------------------------------------------------------------------ InceptionV3
@pytest.fixture(scope="module")
def inception_params():
    """JAX-layout InceptionV3 params drawn with numpy (He-normal HWIO kernels, BN folded to random scales and
    biases, a random fc), much faster than the JAX package's op-by-op init."""
    rng = np.random.default_rng(0)
    params = {}
    convs = [(n, cin, cout, k) for n, cin, cout, k, _, _ in jinc._STEM]
    convs += [(f"{m}.{b}", *spec[0][:3]) for m, _, branches in jinc._MIXED for b, spec in branches.items()]
    for name, cin, cout, k in convs:
        params[name] = {"w": (rng.normal(size=(k[0], k[1], cin, cout)) * np.sqrt(2.0 / (cin * k[0] * k[1])))
                        .astype(np.float32),
                        "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                        "bias": rng.normal(0, 0.1, cout).astype(np.float32)}
    params["fc"] = {"w": (rng.normal(size=(2048, 1000)) * 0.01).astype(np.float32),
                    "b": rng.normal(0, 0.1, 1000).astype(np.float32)}
    return params


def test_inception_every_tap(inception_params):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 80, 80)).astype(np.float32)
    want = jinc._jit_inception_apply(jax.tree_util.tree_map(jnp.asarray, inception_params), jnp.asarray(x), TAPS)
    net = convert.inception_params_from_jax(inception_params)
    with torch.no_grad():
        got = net(torch.from_numpy(x), TAPS)
    for tap in TAPS:
        assert got[tap].shape == (2, tinc.TAP_DIMS[tap])
        _close_to_scale(got[tap].numpy(), np.asarray(want[tap]), 1e-4, tap)
    with torch.no_grad():  # the forward stops at the deepest tap asked for
        assert set(net(torch.from_numpy(x), ("192",))) == {"192"}


def test_inception_converter_takes_every_tensor(inception_params):
    short = {k: v for k, v in inception_params.items() if k != "Mixed_6c.branch7x7_2"}
    with pytest.raises(ValueError, match="Mixed_6c.branch7x7_2"):
        convert.inception_params_from_jax(short)
    fc_t = dict(inception_params, fc={"w": inception_params["fc"]["w"].T, "b": inception_params["fc"]["b"]})
    with pytest.raises(ValueError, match="fc.w"):
        convert.inception_params_from_jax(fc_t)
    # a square kernel read in another layout keeps its shape, and changes the features
    name = "Mixed_7c.branch3x3dbl_3a"
    swapped = dict(inception_params, **{name: dict(inception_params[name],
                                                   w=inception_params[name]["w"].transpose(0, 1, 3, 2).copy())})
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 3, 75, 75)).astype(np.float32))
    with torch.no_grad():
        a = convert.inception_params_from_jax(inception_params)(x, ("pool",))["pool"]
        b = convert.inception_params_from_jax(swapped)(x, ("pool",))["pool"]
    assert not torch.allclose(a, b, rtol=1e-3)


def test_inception_torch_state_dict_folds_batchnorm():
    rng = np.random.default_rng(3)
    sd = {}
    net = tinc.InceptionV3()
    shapes = {name: tuple(net.conv(name).weight.shape) for name in tinc.CONV_NAMES[:3]}
    for name, shape in shapes.items():
        sd[f"{name}.conv.weight"] = rng.normal(size=shape).astype(np.float32)
        for field, lo in (("bn.weight", 0.5), ("bn.bias", -0.1), ("bn.running_mean", -0.2), ("bn.running_var", 0.5)):
            sd[f"{name}.{field}"] = rng.uniform(lo, lo + 1, shape[0]).astype(np.float32)
    want = {k: v for k, v in jinc.load_torch_state_dict({**_full_sd(rng), **sd}).items() if k in shapes}
    got = tinc.load_torch_state_dict({**_full_sd(rng), **sd})
    for name in shapes:
        conv = got.conv(name)
        np.testing.assert_array_equal(conv.weight.detach().numpy(), np.asarray(want[name]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_allclose(conv.scale.detach().numpy(), np.asarray(want[name]["scale"]), rtol=1e-6)
        np.testing.assert_allclose(conv.bias.detach().numpy(), np.asarray(want[name]["bias"]), rtol=1e-6, atol=1e-7)


def _full_sd(rng):
    """A state_dict of every convolution (the first three overwritten by the caller), no fc."""
    sd, net = {}, tinc.InceptionV3()
    for name in tinc.CONV_NAMES:
        shape = tuple(net.conv(name).weight.shape)
        cout = shape[0]
        sd[f"{name}.conv.weight"] = np.zeros(shape, np.float32)
        sd.update({f"{name}.bn.weight": np.ones(cout, np.float32), f"{name}.bn.bias": np.zeros(cout, np.float32),
                   f"{name}.bn.running_mean": np.zeros(cout, np.float32),
                   f"{name}.bn.running_var": np.ones(cout, np.float32)})
    return sd


@pytest.mark.parametrize("size", [32, 512, 299, 100])
def test_preprocess_resize(size):
    """32 -> 299 upsamples (the triangle kernel, as ``F.interpolate``); 512 -> 299 downsamples with JAX's
    antialiasing (unlike ``F.interpolate`` without ``antialias``)."""
    imgs = np.random.default_rng(size).integers(0, 256, (2, 3, size, size)).astype(np.uint8)
    want = np.asarray(jinc.preprocess(jnp.asarray(imgs)))
    got = tinc.preprocess(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    plain = F.interpolate(torch.from_numpy(imgs).float() / 255.0, size=(299, 299), mode="bilinear",
                          align_corners=False).numpy() * 2 - 1
    if size < 299:
        np.testing.assert_allclose(plain, want, atol=1e-5, rtol=0)
    elif size > 299:
        assert np.abs(plain - want).max() > 1e-2


def test_inception_extractor_scales_whole_batch(inception_params):
    net = convert.inception_params_from_jax(inception_params)
    ext = tinc.InceptionFeatureExtractor(net=net, feature="64", device="cpu")
    imgs = np.random.default_rng(4).uniform(0, 1, (2, 3, 40, 40)).astype(np.float32)
    jext = jinc.InceptionFeatureExtractor(params=jax.tree_util.tree_map(jnp.asarray, inception_params), feature="64")
    _close_to_scale(ext(torch.from_numpy(imgs)).numpy(), np.asarray(jext(jnp.asarray(imgs))), 1e-4)
    imgs[1, 0, 0, 0] = 2.0  # one pixel above 1.5: the whole batch is taken at pixel scale
    _close_to_scale(ext(torch.from_numpy(imgs)).numpy(), np.asarray(jext(jnp.asarray(imgs))), 1e-4)


# ------------------------------------------------------------------ FID, MiFID
def _fid_inputs(rng, n, d, rank=None):
    base = rng.normal(size=(n, rank or d))
    feats = base @ rng.normal(size=(rank or d, d)) if rank else base
    return feats


@pytest.mark.parametrize("rank", [None, 5])
def test_compute_fid(rank):
    rng = np.random.default_rng(5)
    a, b = _fid_inputs(rng, 300, 32, rank), _fid_inputs(rng, 280, 32, rank) + 0.3
    mu1, s1, mu2, s2 = a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T)
    want = jgen._compute_fid_np(mu1, s1, mu2, s2)
    got = float(tgen._compute_fid(*(torch.from_numpy(v) for v in (mu1, s1, mu2, s2))))
    if rank is None:
        assert abs(got - want) <= 1e-6 * abs(want)
    else:
        assert abs(got - want) <= 1e-8 * (np.trace(s1) + np.trace(s2))


def _deterministic_pair(dim=16):
    jext = jimg.DeterministicFeatureExtractor(dim=dim, seed=3)
    text = convert.deterministic_features_from_jax([np.asarray(k) for k in jext.kernels], np.asarray(jext.proj),
                                                   device="cpu")
    return jext, text


def _images(seed, n=24, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, size, size)).astype(np.uint8)


def test_deterministic_features_and_converter():
    jext, text = _deterministic_pair()
    imgs = _images(6)
    _close_to_scale(text(torch.from_numpy(imgs)).numpy(), np.asarray(jext(jnp.asarray(imgs))), 1e-5)
    with pytest.raises(ValueError, match="shape"):
        convert.deterministic_features_from_jax([np.asarray(k) for k in jext.kernels], np.asarray(jext.proj).T,
                                                dim=16, device="cpu")
    with pytest.raises(ValueError, match="shape"):  # a kernel left out: the projection no longer fits
        convert.deterministic_features_from_jax([np.asarray(k) for k in jext.kernels][:2], np.asarray(jext.proj),
                                                device="cpu")


def test_fid_class_and_reset_real_features():
    jext, text = _deterministic_pair()
    jm = jimg.FrechetInceptionDistance(feature=jext, reset_real_features=False)
    tm = timg.FrechetInceptionDistance(feature=text, reset_real_features=False, device="cpu")
    for seed, real in ((7, True), (8, False), (9, True), (10, False)):
        imgs = _images(seed, n=40)
        jm.update(jnp.asarray(imgs), real=real)
        tm.update(torch.from_numpy(imgs), real=real)
    for key, w in jm.metric_state.items():
        _close_to_scale(tm.metric_state[key].numpy(), np.asarray(w), 1e-5, key)
    assert abs(float(tm.compute()) - float(jm.compute())) <= 1e-4 * abs(float(jm.compute()))
    # the same states in both packages: FID within 1e-6 relative of JAX's float64 value
    same = timg.FrechetInceptionDistance(feature=text, device="cpu")
    same._state = convert.state_from_jax(same, {k: np.asarray(v) for k, v in jm.metric_state.items()})
    assert abs(float(same.compute()) - float(jm.compute())) <= 1e-6 * abs(float(jm.compute()))
    tm.reset()
    assert int(tm.metric_state["real_features_num_samples"]) == 80
    assert int(tm.metric_state["fake_features_num_samples"]) == 0
    with pytest.raises(RuntimeError, match="More than one sample"):
        tm.compute_state(tm.metric_state)


def test_mifid_class():
    jext, text = _deterministic_pair()
    jm = jimg.MemorizationInformedFrechetInceptionDistance(feature=jext, cosine_distance_eps=0.5)
    tm = timg.MemorizationInformedFrechetInceptionDistance(feature=text, cosine_distance_eps=0.5, device="cpu")
    for seed, real in ((11, True), (12, False)):
        imgs = _images(seed, n=48)
        jm.update(jnp.asarray(imgs), real=real)
        tm.update(torch.from_numpy(imgs), real=real)
    same = timg.MemorizationInformedFrechetInceptionDistance(feature=text, cosine_distance_eps=0.5, device="cpu")
    same._state = convert.state_from_jax(same, {k: [np.asarray(x) for x in v] if isinstance(v, tuple) else
                                                np.asarray(v) for k, v in jm.metric_state.items()})
    want = float(jm.compute())
    assert abs(float(same.compute()) - want) <= 1e-5 * abs(want)
    assert abs(float(tm.compute()) - want) <= 1e-4 * abs(want)
    tm.reset_real_features = False
    tm.reset()
    assert len(tm.metric_state["real_features"]) == 1 and len(tm.metric_state["fake_features"]) == 0


# ------------------------------------------------------------------------- KID
def _terms_scale(x, y, ix, iy, degree, gamma, coef):
    """``(|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2`` a subset, from float64 kernels."""
    out = []
    for rx, ry in zip(ix, iy):
        xs, ys = x[rx].astype(np.float64), y[ry].astype(np.float64)
        m = len(rx)
        k = [np.abs((a @ b.T * gamma + coef) ** degree) for a, b in ((xs, xs), (ys, ys), (xs, ys))]
        out.append((k[0].sum() - np.trace(k[0]) + k[1].sum() - np.trace(k[1])) / (m * (m - 1)) + 2 * k[2].sum() / m**2)
    return np.asarray(out)


@pytest.mark.parametrize(("degree", "gamma", "coef"), [(3, None, 1.0), (1, 0.5, 2.0), (2, 0.01, 1.0), (4, None, 0.5)])
def test_poly_mmd_plain_on_shared_indices(degree, gamma, coef):
    rng = np.random.default_rng(degree)
    x, y = rng.normal(size=(60, 20)).astype(np.float32), (rng.normal(size=(50, 20)) + 0.2).astype(np.float32)
    ix = np.stack([rng.permutation(60)[:17] for _ in range(5)])
    iy = np.stack([rng.permutation(50)[:17] for _ in range(5)])
    g = 1.0 / 20 if gamma is None else gamma
    want = np.asarray(jax.vmap(lambda a, b: jgen.poly_mmd(jnp.asarray(x)[a], jnp.asarray(y)[b], degree, gamma, coef))(
        jnp.asarray(ix), jnp.asarray(iy)))
    got = kpm.poly_mmd_subsets(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(ix), torch.from_numpy(iy),
                               degree, g, coef).numpy()
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * _terms_scale(x, y, ix, iy, degree, g, coef))


F32 = np.float32


def _tf32_split(x):
    """``csrc/poly_mmd.cu``'s ``split``: hi = tf32(x) by ``cvt.rna``'s rounding (0x1000 added to the bits, the low
    13 cleared: to nearest, ties away), a NaN's hi the canonical NaN; lo = tf32(x - hi), 0 where hi is inf or
    NaN."""
    x = np.asarray(x, F32)
    with np.errstate(invalid="ignore", over="ignore"):
        bits = x.view(np.uint32).astype(np.uint64)
        hi = np.where(np.isnan(x), np.uint64(0x7FFFFFFF), (bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)
        rest = (x - hi).view(np.uint32).astype(np.uint64)
        lo = ((rest + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)
        lo = np.where(np.isfinite(hi), lo, F32(0))
    return hi, lo


def _pow32(v, degree):
    """``integer_pow``: binary exponentiation, a float32 rounding a multiply (x^3 = x * (x * x))."""
    acc = None
    while degree > 0:
        if degree & 1:
            acc = v if acc is None else (acc * v).astype(F32)
        degree >>= 1
        if degree > 0:
            v = (v * v).astype(F32)
    return acc


def _tile_of(block, tr, tc):
    """``tile_of``: xy's ``tr x tc`` tiles, then the upper triangles of xx and yy, row tile ``I`` with the column
    tiles from ``first_col_tile(I)`` on."""
    if block < tr * tc:
        return 0, block // tc, block % tc
    b, which, ti = block - tr * tc, 1, 0
    while b >= tc - kpm.first_col_tile(ti):
        b -= tc - kpm.first_col_tile(ti)
        ti += 1
        if ti == tr:
            which, ti = 2, 0
    return which, ti, kpm.first_col_tile(ti) + b


def _tensor_core_dots(a, b, passes=3):
    """A tile's dot products as the kernel takes them: the features zero-filled to whole chunks of
    ``kpm.CHUNK``, each operand split (``_tf32_split``: the kernel splits a tile's rows in registers and its
    columns in shared memory, alike), and a step of 8 features at a time the float32 accumulator gains lo.hi,
    hi.lo and hi.hi (``passes=1``: hi.hi alone), each 8-term product exact and added with one rounding to
    nearest; every ``kpm.PROMOTE`` chunks the accumulators go into float32 sums and start again from zero.
    What numpy cannot model: the tensor cores' order and rounding inside a step (the card's adds are not rounded
    to nearest: the promotion bounds what that costs). A product that comes out inf or NaN is taken again as
    float32 fused multiply-adds in order of k, as the kernel's epilogue takes it."""
    d = a.shape[1]
    width = d + (-d) % kpm.CHUNK
    pad = lambda x: np.pad(x, ((0, 0), (0, width - d)))  # noqa: E731
    (a_hi, a_lo), (b_hi, b_lo) = _tf32_split(pad(a)), _tf32_split(pad(b))
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]
    acc = np.zeros((a.shape[0], b.shape[0]), F32)
    total = np.zeros_like(acc)
    with np.errstate(invalid="ignore", over="ignore"):
        for k0 in range(0, width, 8):
            for p, q in terms:
                acc = (acc + p[:, k0:k0 + 8].astype(np.float64) @ q[:, k0:k0 + 8].T.astype(np.float64)).astype(F32)
            if (k0 + 8) % (kpm.CHUNK * kpm.PROMOTE) == 0:
                total, acc = (total + acc).astype(F32), np.zeros_like(acc)
        acc = (acc + total).astype(F32)
        for i, j in zip(*np.nonzero(~np.isfinite(acc))):
            dot = F32(0)
            for k in range(d):
                dot = F32(np.float64(a[i, k]) * np.float64(b[j, k]) + np.float64(dot))
            acc[i, j] = dot
    return acc


def _kernel_model(x, y, ix, iy, degree, gamma, coef, passes=3):
    """numpy model of ``csrc/poly_mmd.cu``'s tiles: the blocks of a subset mapped as ``tile_of`` maps
    ``blockIdx.x`` (``kpm.ROWS x kpm.COLS`` tiles of xy, then of the upper triangles of xx and yy), each tile's
    products by ``_tensor_core_dots``, ``(dot * gamma) + coef`` rounded twice, the binary power, float64 sums with
    an entry of xy weighing 1, one of xx or yy with i < j weighing 2 and the rest skipped; also counts each
    (matrix, i, j) pair's weight."""
    s_count, m = ix.shape
    tr, tc = kpm.tiles(m)
    out, weights = [], np.zeros((3, m, m))
    for s in range(s_count):
        sums = np.zeros(3)
        for block in range(kpm.blocks(m)):
            which, ti, tj = _tile_of(block, tr, tc)
            a = (y if which == 2 else x)[(iy if which == 2 else ix)[s]]
            b = (x if which == 1 else y)[(ix if which == 1 else iy)[s]]
            rows = np.arange(ti * kpm.ROWS, min(ti * kpm.ROWS + kpm.ROWS, m))
            cols = np.arange(tj * kpm.COLS, min(tj * kpm.COLS + kpm.COLS, m))
            keep = rows[:, None] < cols[None, :] if which else np.ones((len(rows), len(cols)), bool)
            if not keep.any():
                continue
            dot = _tensor_core_dots(a[rows], b[cols], passes)
            w = 2.0 if which else 1.0
            with np.errstate(invalid="ignore", over="ignore"):
                k = _pow32(((dot * F32(gamma)).astype(F32) + F32(coef)).astype(F32), degree)
                sums[which] += w * k.astype(np.float64)[keep].sum()
            if s == 0:
                weights[which][np.ix_(rows, cols)] += w * keep
        out.append((sums[1] + sums[2]) / (m * (m - 1)) - 2 * sums[0] / m**2)
    return np.asarray(out), weights


@pytest.mark.parametrize(("m", "d", "degree"), [(2, 5, 3), (70, 33, 3), (130, 64, 2), (64, 7, 1), (300, 16, 3)])
def test_poly_mmd_kernel_model_against_jax(m, d, degree):
    rng = np.random.default_rng(m)
    x, y = rng.normal(size=(m + 9, d)).astype(np.float32), rng.normal(size=(m + 3, d)).astype(np.float32)
    ix = np.stack([rng.permutation(m + 9)[:m] for _ in range(3)])
    iy = np.stack([rng.permutation(m + 3)[:m] for _ in range(3)])
    got, weights = _kernel_model(x, y, ix, iy, degree, 1.0 / d, 1.0)
    want = np.asarray(jax.vmap(lambda a, b: jgen.poly_mmd(jnp.asarray(x)[a], jnp.asarray(y)[b], degree))(
        jnp.asarray(ix), jnp.asarray(iy)))
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * _terms_scale(x, y, ix, iy, degree, 1.0 / d, 1.0))
    # every pair of xy once, every pair of xx and yy off the diagonal once, through the mirrored tiles
    np.testing.assert_array_equal(weights[0], np.ones((m, m)))
    for which in (1, 2):
        upper = np.triu(weights[which]) + np.tril(weights[which], -1).T
        assert weights[which].sum() == m * (m - 1) and np.all(np.diag(weights[which]) == 0)
        assert upper.sum() == m * (m - 1)


def _kid_like(rng, n, d, shift=0.0, outliers=8, scale=30.0):
    """Features like InceptionV3's pool (ReLU, then the mean: |N(0, 1)| / 2) with ``outliers`` dimensions
    ``scale`` times the others, as trained networks' features have them."""
    x = np.abs(rng.standard_normal((n, d))) * 0.5 + shift
    x[:, :outliers] *= scale
    return x.astype(F32)


def _mmd_float64(x, y, ix, iy, degree, gamma, coef):
    """The subsets' MMD^2 from float64 kernel matrices of the gathered rows."""
    out = []
    for rx, ry in zip(ix, iy):
        xs, ys = x[rx].astype(np.float64), y[ry].astype(np.float64)
        m = len(rx)
        k = [(a @ b.T * gamma + coef) ** degree for a, b in ((xs, xs), (ys, ys), (xs, ys))]
        out.append((k[0].sum() - np.trace(k[0]) + k[1].sum() - np.trace(k[1])) / (m * (m - 1)) - 2 * k[2].sum() / m**2)
    return np.asarray(out)


def test_poly_mmd_three_tf32_passes_within_float64():
    """On KID-like features with outlier dimensions (d = 2,048, m = 130: two row tiles, the second ragged) the
    three-pass model stays within 1e-8 of the terms' scale of a float64 evaluation; one TF32 pass (hi.hi alone)
    errs past 1e-7 on the same inputs."""
    rng = np.random.default_rng(20)
    m, n, d = 130, 150, 2048
    x, y = _kid_like(rng, n, d), _kid_like(rng, n, d, shift=0.05)
    ix = np.stack([rng.permutation(n)[:m] for _ in range(2)])
    iy = np.stack([rng.permutation(n)[:m] for _ in range(2)])
    want = _mmd_float64(x, y, ix, iy, 3, 1.0 / d, 1.0)
    scale = _terms_scale(x, y, ix, iy, 3, 1.0 / d, 1.0)
    three, _ = _kernel_model(x, y, ix, iy, 3, 1.0 / d, 1.0)
    one, _ = _kernel_model(x, y, ix, iy, 3, 1.0 / d, 1.0, passes=1)
    assert np.all(np.abs(three - want) <= 1e-8 * scale), np.abs(three - want) / scale
    assert np.abs(one - want).max() > 1e-7 * scale.max(), np.abs(one - want) / scale


def _tf32_reference(v: float) -> float:
    """The TF32 value nearest float32 ``v`` (10 fraction bits at float32's exponent range, subnormals kept, ties
    away from zero, inf past the largest), in float64 arithmetic, which holds every such value exactly."""
    import math

    if v == 0 or not math.isfinite(v):
        return v
    _, e = math.frexp(abs(v))  # abs(v) = f 2^e, f in [0.5, 1)
    quantum = 2.0 ** (max(e - 1, -126) - 10)
    rounded = math.floor(abs(v) / quantum + 0.5) * quantum
    return math.copysign(rounded if rounded < 2.0**128 else math.inf, v)


@pytest.mark.parametrize("bits", [
    0x00000000, 0x80000000,  # +-0
    0x00000001, 0x00001000, 0x00001FFF, 0x00003000, 0x807FFFFF, 0x007FF000,  # subnormals, ties among them
    0x00800000, 0x3F800000, 0x3F801000, 0x3F803000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x40490FDB,  # ties, pi
    0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF, 0xFF7FFFFF,  # below and at the rounding past FLT_MAX
    0x7F800000, 0xFF800000,  # +-inf
    0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0xFF801000,  # NaNs (CUDA's canonical one among them)
], ids=lambda b: f"{b:#010x}")
def test_poly_mmd_split_rounding(bits):
    """The split's hi and lo bit for bit against an independent rounding; a NaN's hi stays a NaN (the add would
    carry 0x7fffffff into the sign bit: -0) and lo is 0 wherever hi is not finite."""
    x = np.array([bits], np.uint32).view(F32)
    hi, lo = _tf32_split(x)
    if np.isnan(x[0]):
        assert hi.view(np.uint32)[0] == 0x7FFFFFFF and lo.view(np.uint32)[0] == 0
        return
    want_hi = _tf32_reference(float(x[0]))
    assert hi[0] == want_hi and np.signbit(hi[0]) == np.signbit(want_hi)
    want_lo = _tf32_reference(float(x[0]) - want_hi) if np.isfinite(want_hi) else 0.0
    assert lo[0] == want_lo and (want_lo != 0 or lo.view(np.uint32)[0] in (0, 0x80000000))
    if np.isfinite(want_hi) and abs(float(x[0])) >= 2.0**-100:  # hi + lo is x within TF32's precision of the rest
        assert abs(float(x[0]) - want_hi - want_lo) <= abs(float(x[0]) - want_hi) * 2.0**-11


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "+inf", "-inf"])
def test_poly_mmd_kernel_model_non_finite_features(value):
    """A NaN or +-inf feature: the products that come out non-finite are taken again in float32, so the subsets
    that hold the row are NaN where JAX's are, and the others within 1e-5 of the terms' scale."""
    rng = np.random.default_rng(21)
    m, n, d = 20, 60, 24
    x, y = rng.normal(size=(n, d)).astype(F32), rng.normal(size=(n, d)).astype(F32)
    x[5, 3] = value
    ix = np.stack([p[p != 5][:m] for p in (rng.permutation(n) for _ in range(6))])
    ix[0, 0] = ix[3, 11] = 5  # the row in subsets 0 and 3 alone
    iy = np.stack([rng.permutation(n)[:m] for _ in range(6)])
    got, _ = _kernel_model(x, y, ix, iy, 3, 1.0 / d, 1.0)
    want = np.asarray(jax.vmap(lambda a, b: jgen.poly_mmd(jnp.asarray(x)[a], jnp.asarray(y)[b], 3))(
        jnp.asarray(ix), jnp.asarray(iy)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() and not np.isnan(want).all()
    fin = ~np.isnan(want)
    with np.errstate(invalid="ignore"):
        scale = _terms_scale(x, y, ix, iy, 3, 1.0 / d, 1.0)
    np.testing.assert_array_less(np.abs(got - want)[fin], 1e-5 * scale[fin])


def test_kid_with_every_row_in_each_subset():
    """With ``subset_size`` = n every subset is a permutation: the MMD^2 does not depend on the draw."""
    rng = np.random.default_rng(13)
    real, fake = rng.normal(size=(40, 12)).astype(np.float32), (rng.normal(size=(40, 12)) * 1.1).astype(np.float32)
    want_mean, _ = jgen.kid_from_features(jnp.asarray(real), jnp.asarray(fake), subsets=4, subset_size=40)
    mean, std = tgen.kid_from_features(torch.from_numpy(real), torch.from_numpy(fake), subsets=4, subset_size=40,
                                       generator=torch.Generator().manual_seed(1))
    rows = np.arange(40)[None]
    scale = _terms_scale(real, fake, rows, rows, 3, 1.0 / 12, 1.0)[0]
    assert abs(float(mean) - float(want_mean)) <= 1e-5 * scale and float(std) <= 1e-5 * scale
    with pytest.raises(ValueError, match="subset_size"):
        tgen.kid_from_features(torch.from_numpy(real), torch.from_numpy(fake), subsets=2, subset_size=41)


def test_kid_class_and_reset_real_features():
    jext, text = _deterministic_pair()
    tm = timg.KernelInceptionDistance(feature=text, subsets=3, subset_size=30, reset_real_features=False,
                                      device="cpu")
    jm = jimg.KernelInceptionDistance(feature=jext, subsets=3, subset_size=30)
    for seed, real in ((14, True), (15, False)):
        imgs = _images(seed, n=30)
        jm.update(jnp.asarray(imgs), real=real)
        tm.update(torch.from_numpy(imgs), real=real)
    feats = [np.concatenate([np.asarray(v) for v in jm.metric_state[k]]) for k in ("real_features", "fake_features")]
    rows = np.arange(30)[None]
    scale = _terms_scale(feats[0], feats[1], rows, rows, 3, 1.0 / 16, 1.0)[0]
    assert abs(float(tm.compute()[0]) - float(jm.compute()[0])) <= 1e-4 * scale
    tm.reset()
    assert len(tm.metric_state["real_features"]) == 1 and not tm.metric_state["fake_features"]


# -------------------------------------------------------------------------- IS
@pytest.mark.parametrize(("n", "splits"), [(50, 10), (47, 10), (7, 10), (12, 1)])
def test_inception_score(n, splits):
    logits = np.random.default_rng(n).normal(size=(n, 11)).astype(np.float32) * 3
    want = jgen.inception_score_from_logits(jnp.asarray(logits), splits)
    got = tgen.inception_score_from_logits(torch.from_numpy(logits), splits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)


def test_inception_score_class_and_uint8_casts():
    jext, text = _deterministic_pair(dim=10)
    jm = jimg.InceptionScore(feature=jext, splits=3, normalize=True)
    tm = timg.InceptionScore(feature=text, splits=3, normalize=True, device="cpu")
    imgs = np.random.default_rng(16).uniform(0, 1, (30, 3, 32, 32)).astype(np.float32)
    imgs[0, 0, :2, :2] = [[0.0, 1.0], [0.999, 0.5]]
    np.testing.assert_array_equal(timg._maybe_to_uint8(torch.from_numpy(imgs), True).numpy(),
                                  np.asarray(jimg._maybe_to_uint8(jnp.asarray(imgs), True)))
    # outside [0, 1] XLA saturates, where numpy's and torch's own casts wrap: the port clamps first, as XLA
    out = np.array([-0.5, -0.01, 1.2, 1.5, 2.0, 0.999], np.float32)
    np.testing.assert_array_equal(timg._maybe_to_uint8(torch.from_numpy(out), True).numpy(),
                                  np.asarray(jimg._maybe_to_uint8(jnp.asarray(out), True)))
    assert (out * 255).astype(np.uint8)[2] == 50  # numpy wraps 306
    jm.update(jnp.asarray(imgs))
    tm.update(torch.from_numpy(imgs))
    for g, w in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------------ LPIPS
@pytest.mark.parametrize(("net", "size"), [("alex", 64), ("vgg", 64), ("squeeze", 65)])
def test_lpips_backbones(net, size):
    rng = np.random.default_rng(17)
    params = {}
    module = tnets.LPIPSNet(net)
    for name in tnets.conv_names(net):
        o, i, kh, kw = module.conv(name).weight.shape
        params[name] = {"w": (rng.normal(size=(kh, kw, i, o)) * np.sqrt(2.0 / (i * kh * kw))).astype(np.float32),
                        "b": rng.normal(0, 0.05, o).astype(np.float32)}
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    want = jnets.net_apply(net, jax.tree_util.tree_map(jnp.asarray, params), jnets.scaling_layer(jnp.asarray(x)))
    ported = convert.lpips_params_from_jax(net, params)
    backbone = tnets.LPIPSBackbone(net, module=ported, device="cpu")
    got = backbone(torch.from_numpy(x))
    assert len(got) == len(want) == len(tnets._NETS[net][2])
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w), 1e-4)
    jbackbone = jnets.LPIPSBackbone(net, params=jax.tree_util.tree_map(jnp.asarray, params))
    y = rng.uniform(-1, 1, x.shape).astype(np.float32)
    lin = [rng.uniform(0, 1, c).astype(np.float32) for c in tnets._NETS[net][2]]
    for weights in (None, lin):
        w_ = jlp.learned_perceptual_image_patch_similarity(jnp.asarray(x), jnp.asarray(y), net, "sum",
                                                           net=jbackbone, linear_weights=weights)
        g_ = tlp.learned_perceptual_image_patch_similarity(torch.from_numpy(x), torch.from_numpy(y), net, "sum",
                                                           net=backbone, linear_weights=weights)
        np.testing.assert_allclose(float(g_), float(w_), rtol=1e-5)
    with pytest.raises(ValueError, match="do not match"):
        convert.lpips_params_from_jax("vgg" if net != "vgg" else "alex", params)
    left_out = dict(params)
    del left_out[tnets.conv_names(net)[-1]]
    with pytest.raises(ValueError, match="do not match"):
        convert.lpips_params_from_jax(net, left_out)
    name = tnets.conv_names(net)[0]
    flipped = dict(params, **{name: dict(params[name], w=params[name]["w"].transpose(0, 1, 3, 2).copy())})
    with pytest.raises(ValueError, match="shape"):  # the first convolution's 3 input channels read as its outputs
        convert.lpips_params_from_jax(net, flipped)


def test_lpips_functional_checks_and_class():
    jnet = jlp.DeterministicLPIPSNet(seed=2)
    tnet = convert.deterministic_lpips_from_jax([np.asarray(k) for k in jnet.kernels], device="cpu")
    rng = np.random.default_rng(18)
    a, b = rng.uniform(0, 1, (4, 3, 33, 40)).astype(np.float32), rng.uniform(0, 1, (4, 3, 33, 40)).astype(np.float32)
    for g, w in zip(tnet(torch.from_numpy(a)), jnet(jnp.asarray(a))):
        _close_to_scale(g.numpy(), np.asarray(w), 1e-5)
    jm = jimg.LearnedPerceptualImagePatchSimilarity(net=jnet, normalize=True)
    tm = timg.LearnedPerceptualImagePatchSimilarity(net=tnet, normalize=True, device="cpu")
    for _ in range(2):
        jm.update(jnp.asarray(a), jnp.asarray(b))
        tm.update(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=1e-5)
    assert float(tm.metric_state["total"]) == 8.0
    with pytest.raises(ValueError, match="32x32"):
        tlp.learned_perceptual_image_patch_similarity(torch.zeros((1, 3, 31, 40)), torch.zeros((1, 3, 31, 40)),
                                                      net=tnet)
    with pytest.raises(ValueError, match="3 channels"):
        tlp.learned_perceptual_image_patch_similarity(torch.zeros((1, 1, 32, 32)), torch.zeros((1, 1, 32, 32)),
                                                      net=tnet)
    with pytest.raises(ValueError, match="net_type"):
        timg.LearnedPerceptualImagePatchSimilarity(net_type="resnet", device="cpu")


# -------------------------------------------------------------------------- PPL
class _Generator:
    """A seeded linear generator of 3 x 40 x 40 images in [-1, 1] from 8-wide latents, in both packages."""

    num_classes = 3

    def __init__(self, torch_side: bool):
        rng = np.random.default_rng(19)
        self.w = rng.normal(size=(8, 3 * 40 * 40)).astype(np.float32) * 0.3
        self.torch_side = torch_side

    def sample(self, generator, n):
        return torch.randn((n, 8), generator=generator)

    def __call__(self, z, labels=None):
        if self.torch_side:
            return torch.tanh(z @ torch.from_numpy(self.w)).reshape(-1, 3, 40, 40)
        return jnp.tanh(z @ jnp.asarray(self.w)).reshape(-1, 3, 40, 40)


@pytest.mark.parametrize("method", ["lerp", "slerp_any", "slerp_unit"])
def test_ppl_interpolation_and_distances(method):
    rng = np.random.default_rng(20)
    z1, z2 = rng.normal(size=(6, 8)).astype(np.float32), rng.normal(size=(6, 8)).astype(np.float32)
    t = rng.uniform(size=(6, 1)).astype(np.float32)
    want = np.asarray(jimg.PerceptualPathLength._interpolate(*map(jnp.asarray, (z1, z2, t)), method))
    got = timg.PerceptualPathLength._interpolate(*map(torch.from_numpy, (z1, z2, t)), method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    jnet = jlp.DeterministicLPIPSNet(seed=4)
    tnet = convert.deterministic_lpips_from_jax([np.asarray(k) for k in jnet.kernels], device="cpu")
    eps = 1e-2
    tm = timg.PerceptualPathLength(num_samples=6, interpolation_method=method, epsilon=eps, resize=48, sim_net=tnet,
                                   device="cpu")
    got = tm._distances(_Generator(True), torch.from_numpy(z1), torch.from_numpy(z2), torch.from_numpy(t), None)
    gen = _Generator(False)
    za = jimg.PerceptualPathLength._interpolate(jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(t), method)
    zb = jimg.PerceptualPathLength._interpolate(jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(t) + eps, method)
    img_a, img_b = (jax.image.resize(gen(z), (6, 3, 48, 48), "bilinear") for z in (za, zb))
    want = np.asarray(jlp._lpips_from_features(jnet(img_a), jnet(img_b))) / eps**2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_ppl_update_and_discard():
    jnet = jlp.DeterministicLPIPSNet(seed=4)
    tnet = convert.deterministic_lpips_from_jax([np.asarray(k) for k in jnet.kernels], device="cpu")
    tm = timg.PerceptualPathLength(num_samples=10, batch_size=4, conditional=True, sim_net=tnet, resize=None,
                                   device="cpu")
    tm.update(_Generator(True))
    assert tm.metric_state["distances"][0].shape == (10,)
    distances = np.random.default_rng(21).exponential(size=200).astype(np.float32)
    jm = jimg.PerceptualPathLength(num_samples=10, sim_net=jnet, lower_discard=0.05, upper_discard=0.9)
    tm2 = timg.PerceptualPathLength(num_samples=10, sim_net=tnet, lower_discard=0.05, upper_discard=0.9, device="cpu")
    want = jm.compute_state({**jm.init_state(), "distances": (jnp.asarray(distances),)})
    got = tm2.compute_state({**tm2.init_state(), "distances": (torch.from_numpy(distances),)})
    assert got[2].shape == np.asarray(want[2]).shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="sample"):
        tm.update(lambda z: z)
