"""The port's compressed-sync API and int8 codec, held against the JAX package's ``parallel/compress.py``.

One process, no process group: the configuration checks, the byte models
and the planner's compression decisions must equal JAX's exactly (integer
arithmetic); the int8 codec's plain version (the CPU's path) must equal
JAX's ``_quantize_chunks`` / ``_dequantize_chunks`` / ``host_quantize_int8``
bit for bit on the codec's edge cases (chunks of zeros, values half-way
between two codes, the +-127 edges, subnormals, NaN and +-inf); and a
numpy model of the CUDA kernels' algorithm (a warp a chunk, lanes strided
by 32, the butterfly maximum beside a NaN vote, IEEE division, ``rint``,
sums of the rows in order from 0.0 without fused multiply-adds) must equal
JAX bit for bit on the same cases. A world of one rank still quantizes:
the port's compressed sync without a process group equals JAX's on a
one-device mesh bit for bit (int8 and bf16). ``coalesced_host_sync`` with
an injected ``allgather`` equals JAX's in every mode: exact and int8 bit
for bit, bf16 within ``2**-8`` of each chunk's largest value (both sum the
same bfloat16 values in float32, in process order).
"""

from __future__ import annotations

import itertools
from fractions import Fraction

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.core.reductions import Reduce
from torchmetrics_tpu_torch.kernels.int8_codec import _int8_dequant_sum_plain, _int8_quantize_plain
from torchmetrics_tpu_torch.parallel import compress as tcomp
from torchmetrics_tpu_torch.parallel.coalesce import (
    SyncPolicy,
    build_sync_plan,
    coalesced_host_sync,
    coalesced_sync_state,
)
from torchmetrics_tpu_torch.parallel.ragged import packed_int_dtype

CHUNKS = (8, 9, 256, 1024)  # 9: a packed row whose scales are not 4-byte aligned
RCP = np.float32(1.0) / np.float32(127.0)


def _jax():
    import torchmetrics_tpu.parallel.compress as jcomp

    return jcomp


# --------------------------------------------------------------- the API
@pytest.mark.parametrize(("mode", "budget", "floor", "chunk"), [
    ("int8", None, 4096, 256), ("bf16", 0.01, 0, 8), ("int8", 0.05, 10, 1024), ("fp8", None, 4096, 256),
    ("none", None, 4096, 256), ("int8", 0.0, 4096, 256), ("int8", -1.0, 4096, 256), ("bf16", None, -1, 256),
    ("int8", None, 4096, 7), ("int8", None, 4096, 8),
])
def test_compression_config_validation_matches_jax(mode, budget, floor, chunk):
    jcomp = _jax()

    def build(pkg):
        try:
            cfg = pkg.CompressionConfig(mode, error_budget=budget, min_bucket_bytes=floor, chunk=chunk)
            return (cfg.mode, cfg.error_budget, cfg.min_bucket_bytes, cfg.chunk)
        except ValueError as err:
            return ("ValueError", str(err))

    assert build(tcomp) == build(jcomp)


@pytest.mark.parametrize(("mode", "budget"), [(None, None), ("none", None), ("none", 0.1), ("int8", 0.05),
                                              ("bf16", None), ("fp8", None)])
def test_compression_config_from_mode_matches_jax(mode, budget):
    jcomp = _jax()

    def build(pkg):
        try:
            cfg = pkg.CompressionConfig.from_mode(mode, budget)
            return None if cfg is None else (cfg.mode, cfg.error_budget, cfg.min_bucket_bytes, cfg.chunk)
        except ValueError as err:
            return ("ValueError", str(err))

    assert build(tcomp) == build(jcomp)


@pytest.mark.parametrize("kwargs", [
    {}, {"every_n_steps": 3}, {"at_compute": True}, {"every_n_steps": 2, "at_compute": True},
    {"every_n_steps": 0}, {"every_n_steps": -1}, {"every_n_steps": 2.5}, {"every_n_steps": True},
    {"every_n_steps": "3"}, {"compression": "int4"}, {"compression": "bf16", "error_budget": 0.01},
    {"error_budget": 0.1}, {"every_n_steps": 4, "compression": "int8", "error_budget": 0.05},
], ids=str)
def test_sync_policy_validation_matches_jax(kwargs):
    from torchmetrics_tpu.parallel.coalesce import SyncPolicy as JaxPolicy

    def build(cls):
        try:
            p = cls(**kwargs)
        except ValueError as err:
            return ("ValueError", str(err))
        cfg = p.compression_config
        return (p.every_n_steps, p.at_compute, p.defers, [p.should_sync(k) for k in range(6)],
                None if cfg is None else (cfg.mode, cfg.error_budget))

    assert build(SyncPolicy) == build(JaxPolicy)
    assert SyncPolicy.every_n(3) == SyncPolicy(every_n_steps=3)


def test_bounds_and_provenance_match_jax():
    jcomp = _jax()
    assert tcomp.PREDICTED_REL_ERROR == jcomp.PREDICTED_REL_ERROR
    assert tcomp.PREDICTED_EXACT_INT_LIMIT == jcomp.PREDICTED_EXACT_INT_LIMIT
    assert (tcomp.DEFAULT_CHUNK, tcomp.DEFAULT_MIN_BUCKET_BYTES, tcomp.SCALE_BYTES, tcomp.COMPRESSION_MODES) == (
        jcomp.DEFAULT_CHUNK, jcomp.DEFAULT_MIN_BUCKET_BYTES, jcomp.SCALE_BYTES, jcomp.COMPRESSION_MODES)
    for mode, stages, budget in itertools.product(("bf16", "int8"), (1, 2, 3), (None, 0.05)):
        assert tcomp.predicted_error_bound(mode, stages=stages) == jcomp.predicted_error_bound(mode, stages=stages)
        assert tcomp.compression_bound_provenance(mode, budget=budget) == jcomp.compression_bound_provenance(
            mode, budget=budget)
        assert tcomp.predicted_exact_int_limit(mode) == jcomp.predicted_exact_int_limit(mode)


CONFIG_GRID = [None, ("int8", None, 4096, 256), ("bf16", 0.01, 0, 8), ("int8", 0.05, 100, 64),
               ("int8", 1e-6, 0, 256), ("bf16", 1e-3, 4096, 256)]


@pytest.mark.parametrize("config", CONFIG_GRID, ids=str)
def test_compression_spec_for_matches_jax(config):
    jcomp = _jax()
    tcfg = None if config is None else tcomp.CompressionConfig(*config)
    jcfg = None if config is None else jcomp.CompressionConfig(*config)
    for dtype, op, nbytes in itertools.product(("float32", "int32", "float64", "bfloat16"), ("sum", "min", "max"),
                                               (0, 99, 100, 4095, 4096, 1 << 20)):
        got, want = tcomp.compression_spec_for(dtype, op, nbytes, tcfg), jcomp.compression_spec_for(
            dtype, op, nbytes, jcfg)
        assert (got is None) == (want is None), (dtype, op, nbytes)
        if got is not None:
            assert (got.mode, got.chunk, got.error_bound, got.n_collectives) == (
                want.mode, want.chunk, want.error_bound, want.n_collectives)


@pytest.mark.parametrize("granule", [None, 512])
@pytest.mark.parametrize("sharded", [False, True])
def test_wire_byte_models_match_jax(granule, sharded):
    jcomp = _jax()
    sizes = (0, 1, 7, 255, 256, 257, 4096, 100_003, 8_392_704)
    for size, itemsize, n, spec in itertools.product(sizes, (1, 2, 4, 8), (1, 2, 3, 4, 8),
                                                     (None, ("none", 256), ("bf16", 256), ("int8", 256),
                                                      ("int8", 8), ("int8", 1024))):
        tspec = None if spec is None else tcomp.CompressionSpec(*spec)
        jspec = None if spec is None else jcomp.CompressionSpec(*spec)
        got = tcomp.bucket_wire_bytes(size, itemsize, n, tspec, granule=granule, sharded=sharded)
        assert got == jcomp.bucket_wire_bytes(size, itemsize, n, jspec, granule=granule, sharded=sharded)
        assert isinstance(got, int)
        assert tcomp.host_compressed_payload_bytes(size, itemsize, tspec) == jcomp.host_compressed_payload_bytes(
            size, itemsize, jspec)
        for chunk in (8, 256, 1024):
            assert tcomp.int8_block_bytes(size, n, chunk) == jcomp.int8_block_bytes(size, n, chunk)


def test_fid_bucket_bytes_of_the_issue():
    """FID's 2,048-feature float32 sum bucket in a world of 4: 8,196 chunks a block, 2,130,960 packed bytes."""
    size = 2 * (2048 * 2048 + 2048)
    assert size == 8_392_704 and tcomp.int8_block_bytes(size, 4, 256) == 2_130_960
    assert -(-size // (4 * 256)) == 8_196


def test_packed_int_dtype_has_one_copy():
    import torchmetrics_tpu_torch.parallel.ragged as ragged

    assert ragged.packed_int_dtype is tcomp.packed_int_dtype is packed_int_dtype
    with pytest.raises(ValueError, match="lo must be <= hi"):
        packed_int_dtype(torch.int32, (5, 1))


# ----------------------------------------------------------------- the codec
def _edge_values(chunk: int, n_chunks: int, seed: int, subnormal: bool = False) -> np.ndarray:
    """``n_chunks`` chunks: gaussian ones, then one of zeros, exact half-way values, the +-127 edges, a
    normal chunk (or, with ``subnormal=True``, one of subnormals), a NaN and +-inf among finite values, an
    infinite chunk and -0.0."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n_chunks, chunk)) * 10.0 ** rng.integers(-3, 4, (n_chunks, 1))).astype(np.float32)
    kinds = ["zeros", "halfway", "edges", "subnormal" if subnormal else "normal", "nan", "inf", "neg_zero"]
    for row, kind in zip(range(1, n_chunks), kinds):
        if kind == "zeros":
            x[row] = 0.0
        elif kind == "halfway":  # amax 127 * 0.5 -> scale 0.5: (k + 0.5) * 0.5 sits half-way between codes
            k = rng.integers(-126, 126, chunk).astype(np.float32)
            x[row] = (k + 0.5) * np.float32(0.5)
            x[row, 0] = np.float32(63.5)
        elif kind == "edges":
            x[row] = rng.uniform(-1, 1, chunk).astype(np.float32) * 3.0
            x[row, :4] = [3.0, -3.0, 2.9999998, -2.9999998][: min(4, chunk)]
        elif kind == "subnormal":
            x[row] = (rng.integers(-50, 50, chunk) * np.float32(1e-44)).astype(np.float32)
        elif kind == "nan":
            x[row, chunk // 2] = np.nan
            x[row, 0] = np.inf
            x[row, -1] = -np.inf
        elif kind == "inf":
            x[row, 1] = np.inf
            x[row, 2 % chunk] = -np.inf
        elif kind == "neg_zero":
            x[row] = -0.0
    return x.reshape(-1)


def _jax_quantize(flat: np.ndarray, n_chunks: int, chunk: int) -> np.ndarray:
    """JAX's ``_quantize_chunks`` as its sync runs it: jitted (XLA scales by the float32 reciprocal of 127)."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(_jax()._quantize_chunks, static_argnums=(1, 2))
    return np.asarray(fn(jnp.asarray(flat), n_chunks, chunk))


def _jax_dequant(rows: np.ndarray, chunk: int):
    """JAX's unpack of ``k`` packed rows, jitted: the rows side by side, their stacked sum (psum_int8's
    phase 2) and that sum packed again."""
    import jax
    import jax.numpy as jnp

    jcomp = _jax()
    n_chunks = rows.shape[1] // (chunk + 4)

    def fn(packed):
        parts = [jcomp._dequantize_chunks(packed[j], n_chunks, chunk) for j in range(packed.shape[0])]
        partial = jnp.stack(parts).sum(axis=0)
        return jnp.concatenate(parts), partial, jcomp._quantize_chunks(partial, n_chunks, chunk)

    return [np.asarray(v) for v in jax.jit(fn)(jnp.asarray(rows))]


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _kernel_quantize_model(x: np.ndarray, chunk: int, host: bool = False) -> np.ndarray:
    """``quantize_kernel`` of ``csrc/int8_codec.cu``: a warp a chunk, lane l takes elements l, l + 32, ...;
    its max |x| by fmaxf (a NaN dropped) and a NaN flag; the butterfly of fmaxf and the vote; the scale
    ``m * float32(1/127)`` (``host``: ``m / 127``); q = rint(x / scale) by an IEEE float32 division, a NaN 0,
    clamped to +-127; the scale's 4 bytes after the row's payload."""
    rows = x.shape[0]
    n_chunks = x.shape[1] // chunk
    out = np.zeros((rows, n_chunks * (chunk + 4)), np.uint8)
    for r in range(rows):
        for c in range(n_chunks):
            v = x[r, c * chunk : (c + 1) * chunk]
            lanes_m = np.zeros(32, np.float32)
            lanes_nan = np.zeros(32, bool)
            for lane in range(32):
                for i in range(lane, chunk, 32):
                    lanes_nan[lane] |= np.isnan(v[i])
                    lanes_m[lane] = np.fmax(lanes_m[lane], np.abs(v[i]))
            for offset in (16, 8, 4, 2, 1):
                lanes_m = np.fmax(lanes_m, lanes_m[np.arange(32) ^ offset])
            nan = lanes_nan.any()
            m = lanes_m[0]
            if nan or not m > 0:
                scale = np.float32(1.0)
            else:
                scale = np.float32(m / np.float32(127.0)) if host else np.float32(m * RCP)
            with np.errstate(invalid="ignore", divide="ignore"):
                r_ = np.rint(v / scale)
            q = np.where(np.isnan(r_), 0, np.clip(r_, -127, 127)).astype(np.int8)
            out[r, c * chunk : (c + 1) * chunk] = q.view(np.uint8)
            out[r, n_chunks * chunk + 4 * c : n_chunks * chunk + 4 * c + 4] = np.asarray([scale]).view(np.uint8)
    return out


def _round32(exact: Fraction) -> np.float32:
    """The float32 nearest an exact rational, ties to even."""
    x = np.float32(float(exact))  # float64 first, then float32: a double rounding, repaired below
    cands = (np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(np.asarray(c).view(np.uint32)) & 1))


def _fma_model(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``fmaf(a, b, c)``: the exact ``a * b + c`` rounded once."""
    if not (np.isfinite(a) and np.isfinite(b) and np.isfinite(c)):
        with np.errstate(invalid="ignore"):
            return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    return _round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _kernel_dequant_model(packed: np.ndarray, chunk: int, mode: str, requantize: bool, host: bool = False):
    """``dequant_sum_kernel``: q * scale a float32 product; the sum ``fmaf(q0, s0, q1 * s1)`` then
    ``fmaf(qj, sj, acc)`` (``host``: the rounded products added into 0.0f in row order); requantized by the
    quantize model; concat writes each row's values."""
    k = packed.shape[0]
    n_chunks = packed.shape[1] // (chunk + 4)
    width = n_chunks * chunk
    q = packed[:, :width].view(np.int8).reshape(k, n_chunks, chunk).astype(np.float32)
    scale = np.broadcast_to(np.ascontiguousarray(packed[:, width:]).view(np.float32).reshape(k, n_chunks)[..., None],
                            q.shape)
    with np.errstate(invalid="ignore"):
        values = (q * scale).astype(np.float32)
    if mode == "concat":
        return values.reshape(-1)
    if host:
        acc = np.zeros((n_chunks, chunk), np.float32)
        for j in range(k):
            acc = (acc + values[j]).astype(np.float32)
    elif k == 1:
        acc = values[0]
    else:
        acc = np.empty((n_chunks, chunk), np.float32)
        for idx in np.ndindex(n_chunks, chunk):
            a = _fma_model(q[0][idx], scale[0][idx], values[1][idx])
            for j in range(2, k):
                a = _fma_model(q[j][idx], scale[j][idx], a)
            acc[idx] = a
    return _kernel_quantize_model(acc.reshape(1, -1), chunk)[0] if requantize else acc.reshape(-1)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_quantize_plain_and_kernel_model_equal_jax(chunk):
    n_chunks = 9
    flat = _edge_values(chunk, n_chunks, seed=chunk)
    want = _jax_quantize(flat, n_chunks, chunk)
    got = _int8_quantize_plain(torch.from_numpy(flat).reshape(1, -1), chunk)[0].numpy()
    np.testing.assert_array_equal(got, want)
    model = _kernel_quantize_model(flat.reshape(1, -1), chunk)[0]
    np.testing.assert_array_equal(model, want)
    # the pinned non-finite rules: a NaN chunk has scale 1 and codes its infinities +-127; an infinite chunk
    # has scale inf and codes everything 0
    scales = got[n_chunks * chunk :].view(np.float32)
    assert scales[5] == 1.0 and scales[6] == np.inf and scales[2] == 0.5 and scales[1] == 1.0
    codes = got[: n_chunks * chunk].view(np.int8).reshape(n_chunks, chunk)
    assert codes[5, 0] == 127 and codes[5, -1] == -127 and codes[5, chunk // 2] == 0
    assert not codes[6].any() and not codes[1].any() and not codes[7].any()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_subnormal_chunks_keep_ieee_arithmetic(chunk):
    """A kept divergence (ROADMAP Queue 3): XLA on the CPU (and the TPU) treats subnormal floats as zero, so
    JAX codes a chunk of subnormals as zeros with scale 1; PyTorch and the CUDA kernel keep IEEE subnormals,
    so the port scales and codes them. Every other chunk agrees bit for bit."""
    n_chunks = 9
    flat = _edge_values(chunk, n_chunks, seed=chunk, subnormal=True)
    got = _int8_quantize_plain(torch.from_numpy(flat).reshape(1, -1), chunk)[0].numpy()
    np.testing.assert_array_equal(got, _kernel_quantize_model(flat.reshape(1, -1), chunk)[0])
    want = _jax_quantize(flat, n_chunks, chunk)
    codes, want_codes = (v[: n_chunks * chunk].view(np.int8).reshape(n_chunks, chunk) for v in (got, want))
    scales, want_scales = (v[n_chunks * chunk :].view(np.float32) for v in (got, want))
    other = [c for c in range(n_chunks) if c != 4]
    np.testing.assert_array_equal(codes[other], want_codes[other])
    np.testing.assert_array_equal(scales[other], want_scales[other])
    assert want_scales[4] == 1.0 and not want_codes[4].any()  # JAX: flushed to zero
    assert 0.0 < scales[4] < np.finfo(np.float32).tiny and codes[4].any()  # the port: IEEE subnormals

@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k", [1, 4])
def test_dequant_sum_plain_and_kernel_model_equal_jax(chunk, k):
    n_chunks = 8
    rows = np.stack([_jax_quantize(_edge_values(chunk, n_chunks, seed=10 * chunk + j), n_chunks, chunk)
                     for j in range(k)])
    want_concat, want_sum, want_req = _jax_dequant(rows, chunk)
    packed = torch.from_numpy(rows)
    np.testing.assert_array_equal(_bits(_int8_dequant_sum_plain(packed, chunk, "concat").numpy()), _bits(want_concat))
    np.testing.assert_array_equal(_bits(_kernel_dequant_model(rows, chunk, "concat", False)), _bits(want_concat))
    np.testing.assert_array_equal(_bits(_int8_dequant_sum_plain(packed, chunk, "sum").numpy()), _bits(want_sum))
    np.testing.assert_array_equal(_bits(_kernel_dequant_model(rows, chunk, "sum", False)), _bits(want_sum))
    np.testing.assert_array_equal(_int8_dequant_sum_plain(packed, chunk, "sum", True).numpy(), want_req)
    np.testing.assert_array_equal(_kernel_dequant_model(rows, chunk, "sum", True), want_req)
    # the host path: numpy's sum of host_dequantize_int8 of each row
    jcomp = _jax()
    with np.errstate(invalid="ignore"):
        want_host = sum(jcomp.host_dequantize_int8(r, n_chunks * chunk, chunk) for r in rows)
    np.testing.assert_array_equal(_bits(_int8_dequant_sum_plain(packed, chunk, "sum", host=True).numpy()),
                                  _bits(want_host))
    np.testing.assert_array_equal(_bits(_kernel_dequant_model(rows, chunk, "sum", False, host=True)), _bits(want_host))


def test_sum_order_is_rank_order_from_zero():
    """Four rows whose float32 sum depends on the order and on the fused multiply-adds: JAX's jitted stacked
    sum gives fma(q3, s3, fma(q2, s2, fma(q0, s0, q1 s1))), and so do the plain version and the model (a
    sum of the rounded products in order gives 0, a pairwise tree 1)."""
    chunk = 8
    values = np.asarray([[1.0] * chunk, [2.0 ** 24] * chunk, [1.0] * chunk, [-(2.0 ** 24)] * chunk], np.float32)
    rows = np.stack([_jax_quantize(v, 1, chunk) for v in values])
    want = _jax_dequant(rows, chunk)[1]
    got = _int8_dequant_sum_plain(torch.from_numpy(rows), chunk, "sum").numpy()
    tree = (values[0] + values[1]) + (values[2] + values[3])
    assert not np.array_equal(want, tree.astype(np.float32))  # the case tells the orders apart
    assert not np.array_equal(want, _kernel_dequant_model(rows, chunk, "sum", False, host=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_kernel_dequant_model(rows, chunk, "sum", False), want)


def test_in_graph_scale_is_the_reciprocal_multiply():
    """Chunks whose scale differs between ``amax / 127`` and ``amax * float32(1/127)``: jitted JAX takes
    the second, the host path the first, and so do the plain version and the model."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(512, 8)) * 3).astype(np.float32)
    amax = np.abs(x).max(1)
    assert ((amax / np.float32(127)) != (amax * RCP)).any()
    flat = x.reshape(-1)
    want = _jax_quantize(flat, 512, 8)
    np.testing.assert_array_equal(_int8_quantize_plain(torch.from_numpy(x.reshape(1, -1)), 8)[0].numpy(), want)
    np.testing.assert_array_equal(_kernel_quantize_model(x.reshape(1, -1), 8)[0], want)
    host = _jax().host_quantize_int8(flat, 8)
    np.testing.assert_array_equal(_int8_quantize_plain(torch.from_numpy(x.reshape(1, -1)), 8, True)[0].numpy(), host)
    np.testing.assert_array_equal(_kernel_quantize_model(x.reshape(1, -1), 8, host=True)[0], host)
    assert not np.array_equal(want, host)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("length", ["one", "chunk-1", "n*chunk+1"])
def test_host_codec_equals_jax(chunk, length):
    jcomp = _jax()
    size = {"one": 1, "chunk-1": chunk - 1, "n*chunk+1": 4 * chunk + 1}[length]
    flat = _edge_values(chunk, -(-size // chunk) + 7, seed=size)[:size]
    with np.errstate(invalid="ignore"):
        want = jcomp.host_quantize_int8(flat, chunk)
    got = tcomp.host_quantize_int8(torch.from_numpy(flat), chunk)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    padded = np.pad(flat, (0, -size % chunk)).reshape(1, -1)
    with np.errstate(invalid="ignore", divide="ignore"):
        np.testing.assert_array_equal(_kernel_quantize_model(padded, chunk, host=True)[0], want)
    np.testing.assert_array_equal(_bits(tcomp.host_dequantize_int8(got, size, chunk).numpy()),
                                  _bits(jcomp.host_dequantize_int8(want, size, chunk)))


def test_host_roundtrip_within_bound():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=50.0, size=4096).astype(np.float32)
    back = tcomp.host_dequantize_int8(tcomp.host_quantize_int8(torch.from_numpy(x)), x.size).numpy()
    assert np.abs(back - x).max() / np.abs(x).max() <= tcomp.predicted_error_bound("int8")


# -------------------------------------------------- a world of one rank
def _one_device(fn, *arrays):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from torchmetrics_tpu.core.compile import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    body = shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in arrays), out_specs=P(), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(*arrays))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("chunk", [8, 256])
def test_one_rank_compressed_psum_equals_jax_one_device(mode, chunk):
    """Without a process group the compressed all-reduce still quantizes: JAX's one-device psum_int8
    quantizes twice and psum_bf16 rounds to bfloat16."""
    import jax.numpy as jnp

    jcomp = _jax()
    flat = _edge_values(chunk, 6, seed=3)[: 5 * chunk + 3]
    flat = np.where(np.isfinite(flat), flat, 1.5).astype(np.float32)
    want = _one_device(lambda x: jcomp.compressed_psum(x, "data", jcomp.CompressionSpec(mode, chunk)), jnp.asarray(flat))
    got = tcomp.compressed_psum(torch.from_numpy(flat), tcomp.CompressionSpec(mode, chunk)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(got, flat)  # it did quantize
    mat = flat[: 4 * chunk].reshape(1, -1)
    want_s = _one_device(lambda m: jcomp.compressed_psum_scatter(m, "data", jcomp.CompressionSpec(mode, chunk)),
                         jnp.asarray(mat))
    got_s = tcomp.compressed_psum_scatter(torch.from_numpy(mat), tcomp.CompressionSpec(mode, chunk)).numpy()
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))


def test_one_rank_coalesced_sync_with_compression_equals_jax():
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel.coalesce import coalesced_sync_state as jax_sync

    rng = np.random.default_rng(5)
    state = {"big": rng.normal(size=(40, 50)).astype(np.float32) * 7, "mean": rng.normal(size=(2000,)).astype(np.float32),
             "count": np.asarray(3, np.int32), "_n": np.asarray(2, np.int32)}
    table = {"big": "sum", "mean": "mean", "count": "sum"}
    for mode in ("bf16", "int8"):
        jcfg = _jax().CompressionConfig(mode, min_bucket_bytes=0, chunk=64)
        tcfg = tcomp.CompressionConfig(mode, min_bucket_bytes=0, chunk=64)
        want = _one_device(lambda st: jax_sync(st, {k: Reduce(v) for k, v in table.items()}, "data",
                                               compression=jcfg), {k: jnp.asarray(v) for k, v in state.items()})
        got = coalesced_sync_state({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, table,
                                   compression=tcfg)
        for k, w in want.items():
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(w), err_msg=f"{mode} {k}")


# --------------------------------------------------------- the host sync
def _host_state(seed):
    rng = np.random.default_rng(seed)
    return {"cov": (rng.normal(size=(30, 30)) * 4).astype(np.float32), "mu": rng.normal(size=(30,)).astype(np.float32),
            "hi": rng.normal(size=(3,)).astype(np.float32), "n": np.asarray(7, np.int32), "_n": np.asarray(1, np.int32)}


HOST_TABLE = {"cov": "sum", "mu": "mean", "hi": "max", "n": "sum"}


def _arrivals(x: np.ndarray) -> np.ndarray:
    """Three processes' payloads: this one's and two derived from it (the packed int8 bytes repeated)."""
    if x.dtype == np.uint8:
        return np.stack([x, x, x])
    if x.dtype == np.float32:
        return np.stack([x, x * np.float32(-0.5) + np.float32(1.0), x[::-1].copy()])
    return np.stack([x, x + 1, x * 2])


def _torch_allgather(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return torch.from_numpy(_arrivals(x.float().numpy())).to(torch.bfloat16)
    return torch.from_numpy(_arrivals(x.numpy()))


def _jax_allgather(x):
    import jax.numpy as jnp

    if str(x.dtype) == "bfloat16":
        return jnp.asarray(_arrivals(np.asarray(jnp.asarray(x).astype(jnp.float32)))).astype(jnp.bfloat16)
    return _arrivals(np.asarray(x))


@pytest.mark.parametrize("mode", [None, "bf16", "int8"])
def test_coalesced_host_sync_with_injected_allgather_equals_jax(mode):
    """Three processes through an injected ``allgather``: the port and JAX reduce the same arrivals alike."""
    from torchmetrics_tpu.parallel.coalesce import coalesced_host_sync as jax_host_sync

    state = _host_state(1)
    jcfg = None if mode is None else _jax().CompressionConfig(mode, min_bucket_bytes=0, chunk=16)
    tcfg = None if mode is None else tcomp.CompressionConfig(mode, min_bucket_bytes=0, chunk=16)
    want = jax_host_sync(state, {k: Reduce(v) for k, v in HOST_TABLE.items()}, n_processes=3,
                         allgather=_jax_allgather, compression=jcfg)
    got = coalesced_host_sync({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, HOST_TABLE,
                              n_processes=3, allgather=_torch_allgather, compression=tcfg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if mode == "bf16" and HOST_TABLE.get(k) in ("sum", "mean") and g.dtype == np.float32:
            assert np.abs(g - w).max() <= 2.0 ** -8 * (np.abs(w).max() or 1.0), k
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def test_coalesced_host_sync_one_process_returns_the_state():
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in _host_state(2).items()}
    out = coalesced_host_sync(state, HOST_TABLE, compression=tcomp.CompressionConfig("int8", min_bucket_bytes=0))
    assert out.keys() == state.keys() and all(out[k] is state[k] for k in state)


# ------------------------------------------------------------ the plans
def test_compressed_plan_fields_equal_jax_for_a_mixed_table():
    import jax.numpy as jnp

    from torchmetrics_tpu.parallel.coalesce import build_sync_plan as jax_plan

    state = {"a": np.zeros((64, 64), np.float32), "b": np.zeros((3,), np.float32), "m": np.zeros((5,), np.float32),
             "lo": np.zeros((2,), np.float32), "i": np.zeros((4,), np.int32), "c": np.zeros((2, 3), np.float32),
             "_n": np.zeros((), np.int32)}
    table = {"a": "sum", "b": "sum", "m": "mean", "lo": "min", "i": "sum", "c": "cat"}
    for config in CONFIG_GRID:
        tcfg = None if config is None else tcomp.CompressionConfig(*config)
        jcfg = None if config is None else _jax().CompressionConfig(*config)
        got = build_sync_plan([(table, {k: torch.from_numpy(v) for k, v in state.items()})], compression=tcfg)
        want = jax_plan([({k: Reduce(v) for k, v in table.items()}, {k: jnp.asarray(v) for k, v in state.items()})],
                        compression=jcfg)
        assert _plan_fields(got) == _plan_fields(want), config
        assert got.n_collectives == want.n_collectives


def _plan_fields(plan):
    return [(b.dtype, b.op, b.sharded, None if b.compression is None else
             (b.compression.mode, b.compression.chunk, b.compression.error_bound),
             [(s.entry, s.name, tuple(s.shape), s.size, s.mean, s.shard_axis) for s in b.slots], b.n_collectives)
            for b in plan.buckets]
