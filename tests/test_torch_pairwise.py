"""Parity of the port's pairwise functions with the JAX package, and the ``pairwise_lp`` kernel's model.

The same seeded numpy inputs (up to 40 x 37 rows of width up to 70) go
through both packages; the port runs on the CPU, where the Manhattan and
Minkowski distances are the plain version of the ``pairwise_lp`` kernel
(``chip_smoke.py`` holds the kernel against it on the card).

Tolerances: 1e-5 relative and 1e-6 absolute for every function (float32
sums of at most 70 terms in another order than XLA's), NaN placement equal;
the Euclidean distance also within ``sqrt(8 * 2**-24 * max(|x|^2 + |y|^2))``
absolute: its expansion ``|x|^2 + |y|^2 - 2 x.y`` cancels near 0, where a few
float32 roundings of the squared norms pass through the square root (1.95e-3
on the diagonal of 21-wide rows). The kernel's model (float32 sums in order
of ``k`` over zero-padded groups of 4 columns, a fused multiply-add a term for
p = 2 and for a float p's fast form ``ex2(p lg2(mant)) * 2^(p (E - 127))``) is
held against JAX and the plain version within 1e-6 relative plus the float32
summation bound of the ``d`` terms, ``d * 2**-24 * sum |term|``, taken
through the root. The fast form is also held at the special-function unit's
error bounds (lg2 +-2^-22.6 absolute, ex2 +-2 ulp) within that tolerance at
d = 1 over |d| from 1e-30 to 1e30, where the naive ``ex2(p lg2|d|)`` fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.pairwise as jpw
import torchmetrics_tpu_torch.functional.pairwise as tpw
import torchmetrics_tpu_torch.functional.pairwise.pairwise as tpw_module
from torchmetrics_tpu_torch.kernels import pairwise as kpw

F32 = np.float32
TOL = (1e-5, 1e-6)
NAMES = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
         "pairwise_manhattan_distance", "pairwise_minkowski_distance"]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


def _rows(seed, n, d, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))).astype(F32)


def _euclid_atol(x, y):
    y = x if y is None else y
    sq = [(a.astype(np.float64) ** 2).sum(1).max() for a in (x, y)]
    return float(np.sqrt(8 * 2.0**-24 * (sq[0] + sq[1])))


def _both(name, x, y, **kwargs):
    jy = None if y is None else jnp.asarray(y)
    ty = None if y is None else torch.from_numpy(y)
    return getattr(tpw, name)(torch.from_numpy(x), ty, **kwargs), getattr(jpw, name)(jnp.asarray(x), jy, **kwargs)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
def test_functions_against_jax(name, with_y, reduction, zero_diagonal):
    x = _rows(1, 13, 21)
    y = _rows(2, 11, 21) if with_y else None
    got, want = _both(name, x, y, reduction=reduction, zero_diagonal=zero_diagonal)
    atol = _euclid_atol(x, y) * (x.shape[0] if reduction == "sum" else 1) if "euclidean" in name else TOL[1]
    _close(got, want, (TOL[0], atol))


@pytest.mark.parametrize("exponent", [1, 2, 2.0, 3, 4, 5, 0.5, 1.5, 3.0])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 7, 33), (40, 37, 70)])
def test_minkowski_exponents_against_jax(exponent, shape):
    n, m, d = shape
    x, y = _rows(3, n, d), _rows(4, m, d)
    got, want = _both("pairwise_minkowski_distance", x, y, exponent=exponent)
    _close(got, want)


def test_manhattan_float64_and_integer_inputs_narrow_to_float32():
    x = np.random.default_rng(5).integers(-5, 5, size=(6, 4))
    got, want = tpw.pairwise_manhattan_distance(torch.from_numpy(x)), jpw.pairwise_manhattan_distance(jnp.asarray(x))
    assert got.dtype == torch.float32
    _close(got, want)
    xd = _rows(6, 6, 4).astype(np.float64)
    _close(tpw.pairwise_euclidean_distance(torch.from_numpy(xd)), jpw.pairwise_euclidean_distance(jnp.asarray(xd)))


@pytest.mark.parametrize("name", NAMES)
def test_non_finite_rows_and_zero_diagonal(name):
    """NaN and +-inf rows propagate as in JAX; ``zero_diagonal`` multiplies by ``1 - eye``, so a
    non-finite diagonal becomes NaN, not 0."""
    x = _rows(7, 6, 5)
    x[1, 2] = np.nan
    x[3, 0] = np.inf
    x[4, 4] = -np.inf
    for zero_diagonal in (None, True, False):
        got, want = _both(name, x, None, zero_diagonal=zero_diagonal)
        _close(got, want)
    got, want = _both(name, x, _rows(8, 4, 5), zero_diagonal=True)
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_errors_as_jax(name):
    cases = [((np.ones((3,), F32), None), {}), ((np.ones((3, 2), F32), np.ones((3, 4), F32)), {}),
             ((np.ones((3, 2), F32), np.ones((3,), F32)), {}), ((np.ones((3, 2), F32), None), {"reduction": "max"})]
    if name == "pairwise_minkowski_distance":
        cases += [((np.ones((3, 2), F32), None), {"exponent": 0}), ((np.ones((3, 2), F32), None), {"exponent": -1.5}),
                  ((np.ones((3, 2), F32), None), {"exponent": "2"})]
    for (x, y), kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(jpw, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tpw, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
        assert str(got.value) == str(want.value)


def test_matmul_runs_with_tf32_off_and_restores_the_flag():
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with tpw_module._full_precision_matmul():
            assert matmul.allow_tf32 is False
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = before


# ----------------------------------------------------------------- the kernel: plan, launcher, model
def test_integer_pow_is_jax_binary_exponentiation():
    x = torch.tensor([1.1, -0.7, 3.3, 1e-4, np.inf, np.nan])  # no denormal power: XLA's CPU flushes them
    for n in range(1, 9):
        want = np.asarray(jnp.asarray(x.numpy()) ** n)
        np.testing.assert_array_equal(kpw._integer_pow(x, n).numpy(), want)


def test_plain_version_blocks_rows_without_changing_sums():
    """The plain version broadcasts a block of rows at a time; every block size gives the same matrix."""
    x, y = _rows(40, 37, 19), _rows(41, 23, 19)
    whole = kpw._pairwise_lp_plain(torch.from_numpy(x), torch.from_numpy(y), 3, "pow")
    before = kpw.PLAIN_BLOCK_ELEMENTS
    try:
        for block in (1, 23 * 19, 5 * 23 * 19):
            kpw.PLAIN_BLOCK_ELEMENTS = block
            blocked = kpw._pairwise_lp_plain(torch.from_numpy(x), torch.from_numpy(y), 3, "pow")
            np.testing.assert_array_equal(blocked.numpy(), whole.numpy())
    finally:
        kpw.PLAIN_BLOCK_ELEMENTS = before
    assert kpw._pairwise_lp_plain(torch.zeros((0, 4)), torch.zeros((3, 4)), 1, None).shape == (0, 3)


def test_launcher_refuses_what_it_does_not_take():
    x = torch.zeros((4, 3))
    for args, msg in [((x, x, 0, None), "positive"), ((x, x, -1.0, None), "positive"), ((x, x, True, None), "positive"),
                      ((x, x, 2, "cube"), "root"), ((x, torch.zeros((4, 2)), 1, None), "(M, d)"),
                      ((x.double(), x, 1, None), "float32"), ((x.t(), x.t(), 1, None), "contiguous"),
                      ((x, x, 1, None), "CUDA tensors only")]:
        with pytest.raises(ValueError, match=msg.replace("(", r"\(").replace(")", r"\)")):
            kpw.pairwise_lp(*args)
    assert kpw.pairwise_lp.launches == 0


LG2_ERR = 2.0**-22.6  # lg2.approx.f32's absolute error on [1, 2) by the PTX ISA (2^-22.577 measured on an H100)
EX2_ULPS = 2  # ex2.approx.f32's error bound used here (1.40 ulp measured on [0, 8) on an H100)


def _pow_table(p) -> np.ndarray:
    """The launcher's table of a float ``p``: ``2^(p (E - 127))`` rounded once from float64 to float32 for every
    binary exponent ``E`` whose terms ``mant^p 2^(p (E - 127))``, ``mant`` in [1, 2), lie in [2^-126, 2^127];
    -1 elsewhere (zero and subnormal ``d`` at ``E = 0``, inf and NaN at 255): the accurate path."""
    e = np.arange(256, dtype=np.float64)
    pd = float(F32(p))
    lo, hi = pd * (e - 127), pd * (e - 126)
    fast = (e >= 1) & (e <= 254) & (lo >= -126) & (hi <= 127)
    return np.where(fast, np.exp2(lo), -1.0).astype(F32)


def _ulps(v: np.ndarray, n: int) -> np.ndarray:
    for _ in range(abs(n)):
        v = np.nextafter(v, F32(np.inf) if n > 0 else F32(0)).astype(F32)
    return v


def _fast_terms(diff: np.ndarray, p, lg2_shift: float = 0.0, ex2_ulps: int = 0):
    """A float ``p``'s fast form as the kernel takes it: ``|d| = mant 2^(E - 127)`` from the bits of ``d``, then
    ``r = ex2(float32(p lg2(mant)))`` and ``scale = table[E]``; the term is ``r * scale`` (the kernel adds it to
    the sum in one fused multiply-add). ``lg2_shift`` moves lg2's float64 value before its float32 rounding,
    ``ex2_ulps`` moves ex2's rounded result by whole ulps: the error bounds of the special-function unit."""
    bits = np.ascontiguousarray(diff, F32).view(np.uint32)
    mant = ((bits & 0x7FFFFF) | 0x3F800000).view(F32)
    scale = _pow_table(p)[(bits >> 23) & 0xFF]
    u = (F32(p) * (np.log2(mant.astype(np.float64)) + lg2_shift).astype(F32)).astype(F32)
    r = _ulps(np.exp2(u.astype(np.float64)).astype(F32), ex2_ulps)
    return r, scale


def _kernel_model(x: np.ndarray, y: np.ndarray, p, root):
    """The kernel's order in numpy: groups of 4 columns (chunks of ``CHUNK``), zero past ``d``; each output a
    float32 sum in order of ``k``: ``acc + |d|`` (p = 1), ``fma(d, d, acc)`` (int 2, rounded once from float64,
    where the product is exact), ``acc + integer_pow(|d|)`` (other ints); a float ``p``: ``fma(r, scale, acc)``
    where the table holds ``scale`` (:func:`_fast_terms`, lg2 and ex2 taken as correctly rounded), else
    ``acc + |d| ** p`` (the accurate path; zero adds nothing); then the root."""
    n, d = x.shape
    m = y.shape[0]
    width = -(-d // 4) * 4
    xp, yp = np.zeros((n, width), F32), np.zeros((m, width), F32)
    xp[:, :d], yp[:, :d] = x, y
    acc = np.zeros((n, m), F32)
    with np.errstate(all="ignore"):
        for k in range(width):
            diff = (xp[:, k, None] - yp[None, :, k]).astype(F32)
            if isinstance(p, int) and p == 1:
                acc = (acc + np.abs(diff)).astype(F32)
            elif isinstance(p, int) and p == 2:
                acc = (acc.astype(np.float64) + diff.astype(np.float64) ** 2).astype(F32)
            elif isinstance(p, int):
                acc = (acc + kpw._integer_pow(torch.from_numpy(np.abs(diff)), p).numpy()).astype(F32)
            else:
                r, scale = _fast_terms(diff, p)
                fused = (acc.astype(np.float64) + r.astype(np.float64) * scale.astype(np.float64)).astype(F32)
                accurate = (acc + np.power(np.abs(diff), F32(p))).astype(F32)
                acc = np.where(scale >= 0, fused, accurate).astype(F32)
        if root == "pow":
            return np.power(acc, F32(1.0 / p)).astype(F32), acc
        return (np.sqrt(acc).astype(F32) if root == "sqrt" else acc), acc


def _within_summation_bound(got, want, terms_abs_sum, d, p, root):
    """``|got - want| <= 1e-6 |want| + d 2**-24 sum |term|``, the bound taken through the root."""
    bound = d * 2.0**-24 * terms_abs_sum
    if root == "pow":
        bound = bound / p * np.power(np.maximum(terms_abs_sum, 1e-30), 1.0 / p - 1.0)
    elif root == "sqrt":
        bound = bound / 2.0 / np.sqrt(np.maximum(terms_abs_sum, 1e-30))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(got[~finite], want[~finite])
    err = np.abs(got[finite] - want[finite])
    assert (err <= 1e-6 * np.abs(want[finite]) + bound[finite] + 1e-30).all(), float(err.max())


@pytest.mark.parametrize("p", [1, 2, 2.0, 3, 0.5, 1.5])
@pytest.mark.parametrize("shape", [(1, 1, 1), (31, 33, 31), (33, 31, 33), (7, 9, 97)])
def test_kernel_model_against_jax_and_plain(p, shape):
    n, m, d = shape
    x, y = _rows(10 + d, n, d), _rows(20 + d, m, d)
    got, sums = _kernel_model(x, y, p, "pow")
    want = np.asarray(jpw.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=p))
    plain = kpw._pairwise_lp_plain(torch.from_numpy(x), torch.from_numpy(y), p, "pow").numpy()
    terms = np.sum(np.abs(x[:, None, :] - y[None, :, :]).astype(np.float64) ** float(p), -1)
    _within_summation_bound(got, want, terms, d, p, "pow")
    _within_summation_bound(plain, want, terms, d, p, "pow")
    if p == 1:
        _within_summation_bound(_kernel_model(x, y, 1, None)[0],
                                np.asarray(jpw.pairwise_manhattan_distance(jnp.asarray(x), jnp.asarray(y))),
                                terms, d, 1, None)


def test_kernel_model_non_finite_and_centroid_norm():
    """NaN and +-inf rows as IEEE arithmetic has them; the ``sqrt`` root is ``jnp.linalg.norm``'s."""
    x, y = _rows(30, 9, 40), _rows(31, 8, 40)
    x[2, 5], x[4, 0], y[3, 39] = np.nan, np.inf, -np.inf
    for p in (1, 2, 3, 1.5):
        got, _ = _kernel_model(x, y, p, "pow")
        want = np.asarray(jpw.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=p))
        assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(np.isinf(got), np.isinf(want))
    means = _rows(32, 12, 40)
    got, _ = _kernel_model(means, means, 2, "sqrt")
    want = np.asarray(jnp.linalg.norm(jnp.asarray(means)[:, None, :] - jnp.asarray(means)[None, :, :], axis=-1))
    _close(got, want, (1e-6, 1e-6))


def _d1_error_over_tolerance(terms32: np.ndarray, ad: np.ndarray, p) -> np.ndarray:
    """Phase 3's check at d = 1, as a share of its tolerance: the root of the float32 term against the root of the
    correctly rounded float32 ``|d|^p`` (the plain version), both roots correctly rounded; the tolerance 1e-6
    relative plus the float32 summation bound of one term taken through the root, plus 1e-30."""
    terms = ad.astype(np.float64) ** float(F32(p))
    inv = float(F32(1.0 / p))
    with np.errstate(all="ignore"):
        want = np.power(terms.astype(F32).astype(np.float64), inv).astype(F32).astype(np.float64)
        got = np.power(terms32.astype(np.float64), inv).astype(F32).astype(np.float64)
        bound = 2.0**-24 * terms / p * terms ** (1.0 / p - 1.0)
        return np.abs(got - want) / (1e-6 * want + bound + 1e-30)


@pytest.mark.parametrize("p", [0.5, 1.5, 2.0, 2.5, 5.5])
def test_float_exponent_form_within_phase3_tolerance(p):
    """The fast form at its error bounds (lg2 moved by +-2^-22.6, ex2 by +-2 ulp) stays within phase 3's tolerance
    at d = 1 for |d| from 1e-30 to 1e30, wherever the table sends a pair to it; the naive form
    ``ex2(float32(p float32(lg2|d|)))`` under the same bounds does not (the float32 rounding of lg2|d|, up to 149
    in size, and of its product with p)."""
    ad = np.exp(np.linspace(np.log(1e-30), np.log(1e30), 200_001)).astype(F32)
    fast = _pow_table(p)[(ad.view(np.uint32) >> 23) & 0xFF] >= 0
    assert fast.mean() > 0.2
    worst, naive_worst = 0.0, 0.0
    with np.errstate(all="ignore"):
        for shift in (-LG2_ERR, LG2_ERR):
            for ulps in (-EX2_ULPS, EX2_ULPS):
                r, scale = _fast_terms(ad, p, shift, ulps)
                terms32 = (r.astype(np.float64) * scale.astype(np.float64)).astype(F32)
                worst = max(worst, float(_d1_error_over_tolerance(terms32, ad, p)[fast].max()))
                u = (F32(p) * (np.log2(ad.astype(np.float64)) + shift).astype(F32)).astype(F32)
                naive = _ulps(np.exp2(u.astype(np.float64)).astype(F32), ulps)
                naive_worst = max(naive_worst, float(_d1_error_over_tolerance(naive, ad, p)[fast].max()))
    assert worst <= 1.0, worst
    assert naive_worst > 1.0, naive_worst


@pytest.mark.parametrize("p", [0.5, 1.5, 5.5])
def test_kernel_model_at_wide_magnitudes_and_subnormal_differences(p):
    """Phase 3's rows of magnitudes from 1e-30 to 1e30 with subnormal differences: the model (fast form where the
    table has the power, the accurate path elsewhere) against the plain version and JAX within phase 3's
    tolerance, at d = 1 and over 97 columns."""
    rng = np.random.default_rng(50)
    for d in (1, 97):
        x = (rng.choice([-1.0, 1.0], (24, d)) * 10.0 ** rng.uniform(-30, 30, (24, d))).astype(F32)
        y = (rng.choice([-1.0, 1.0], (20, d)) * 10.0 ** rng.uniform(-30, 30, (20, d))).astype(F32)
        tiny = np.float32(2.0**-120)
        x[:4], y[:4] = tiny * (1 + np.arange(4 * d).reshape(4, d) % 7 * 2.0**-23), tiny  # subnormal differences
        x[4, :] = np.float32(1e-40)  # subnormal values
        got, sums = _kernel_model(x, y, p, "pow")
        plain = kpw._pairwise_lp_plain(torch.from_numpy(x), torch.from_numpy(y), p, "pow").numpy()
        with np.errstate(all="ignore"):
            terms = np.sum(np.abs(x[:, None, :].astype(np.float64) - y[None, :, :]) ** float(p), -1)
        _within_summation_bound(got, plain, terms, d, p, "pow")
        if d == 1:
            want = np.asarray(jpw.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=p))
            finite = np.isfinite(want) & (np.abs(want) > 1e-37)  # XLA's CPU flushes subnormal results
            assert np.array_equal(np.isnan(got[finite]), np.isnan(want[finite]))
            _within_summation_bound(got[finite], want[finite], terms[finite], d, p, "pow")


def test_tile_fills_the_card():
    """128 x 128 tiles for an integer p where they give every SM two blocks, 64 x 64 otherwise."""
    assert kpw.tile(3368, 19732, 1, 132) == (8, 8) and kpw.tile(3368, 19732, 3, 132) == (8, 8)
    assert kpw.tile(3368, 19732, 1.5, 132) == (4, 4)
    assert kpw.tile(1024, 1024, 1, 132) == (4, 4) and kpw.tile(1000, 1000, 2, 132) == (4, 4)
    for n, m, p in ((1024, 1024, 1), (1000, 1000, 2), (3368, 19732, 3), (3368, 19732, 1.5), (50_000, 3, 1)):
        rows, cols = kpw.tile(n, m, p, 132)
        assert (rows, cols) in kpw.TILES
        assert -(-n // (kpw.ROW_THREADS * rows)) * -(-m // (kpw.COL_THREADS * cols)) >= 132 or n * m < 2**21
        assert -(-m // (kpw.COL_THREADS * cols)) <= 65_535 or m > kpw.MAX_COLS
