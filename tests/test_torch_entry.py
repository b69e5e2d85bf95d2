"""The port's slice as a whole, held against the JAX package.

* the JAX entry's own inputs through ``__graft_entry__.entry()`` and the
  port's ``_entry.entry(device="cpu")``;
* the eager facade (update/compute/forward/reset) over several batches;
* a JAX state carried into the port mid-stream (``convert.state_from_jax``);
* state dicts, pickling and the device contract;
* the port imports neither JAX nor the JAX package.

Tolerances are those of the per-module tests: integer states exact,
classification scores ``rtol=1e-6, atol=1e-7``, AUROC and MSE ``rtol=1e-5``
(float32 sums taken in another order than XLA's).
"""

import ast
import doctest
import importlib
import os
import pickle
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.regression as jreg
import torchmetrics_tpu_torch
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.regression as treg
from torchmetrics_tpu_torch import _entry
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError, TorchMetricsUserError

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "torchmetrics_tpu_torch"
TOL = {"accuracy": (1e-6, 1e-7), "f1": (1e-6, 1e-7), "auroc": (1e-5, 0.0), "mse": (1e-5, 0.0)}
C = 10


def _metrics(pkg_cls, pkg_reg, **device):
    return {
        "accuracy": pkg_cls.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **device),
        "f1": pkg_cls.MulticlassF1Score(num_classes=C, average="macro", validate_args=False, **device),
        "auroc": pkg_cls.MulticlassAUROC(num_classes=C, thresholds=20, validate_args=False, **device),
        "mse": pkg_reg.MeanSquaredError(**device),
    }


def _inputs(name, seed, n=64):
    rng = np.random.default_rng(seed)
    if name == "mse":
        values = rng.normal(size=n).astype(np.float32)
        return values, (values + rng.normal(scale=0.2, size=n)).astype(np.float32)
    logits = rng.normal(size=(n, C)).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    return probs, rng.integers(0, C, size=n).astype(np.int32)


def _close(name, got, want):
    rtol, atol = TOL[name]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _state_np(state):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}


def _assert_state_matches(name, torch_state, jax_state):
    want = _state_np(jax_state)
    assert set(torch_state) == set(want)
    for k, w in want.items():
        g = torch_state[k].cpu().numpy()
        assert g.dtype == w.dtype, (name, k)
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(name, g, w)


def test_entry_parity_on_the_jax_entry_inputs():
    jax_step, jax_inputs = __graft_entry__.entry()
    want = jax_step(*jax_inputs)
    step, own_inputs = _entry.entry(device="cpu")
    got = step(*[torch.from_numpy(np.array(x)) for x in jax_inputs])
    assert set(got) == set(want) == set(TOL)
    for name in TOL:
        assert got[name].dtype == torch.float32
        _close(name, got[name].numpy(), want[name])
    # the port's own inputs: a 64x10 batch made by a seeded torch.Generator
    probs, target, values, references = own_inputs
    assert probs.shape == (64, C) and target.shape == values.shape == references.shape == (64,)
    assert all(torch.isfinite(v).all() for v in step(*own_inputs).values())
    torch.testing.assert_close(probs, _entry.entry(device="cpu")[1][0], rtol=0, atol=0)


def test_eager_facade_parity():
    jax_m, torch_m = _metrics(jc, jreg), _metrics(tc, treg, device="cpu")
    for name in TOL:
        jm, tm = jax_m[name], torch_m[name]
        for seed in range(3):
            x, y = _inputs(name, seed)
            jm.update(jnp.asarray(x), jnp.asarray(y))
            tm.update(torch.from_numpy(x), torch.from_numpy(y))
        _close(name, tm.compute(), jm.compute())
        assert tm.compute() is tm.compute()  # cached until the next update
        x, y = _inputs(name, 10)
        _close(name, tm(torch.from_numpy(x), torch.from_numpy(y)), jm(jnp.asarray(x), jnp.asarray(y)))
        _assert_state_matches(name, tm.metric_state, jm.metric_state)
        _close(name, tm.compute(), jm.compute())
        assert tm.update_count == jm.update_count == 4
        tm.reset()
        jm.reset()
        _assert_state_matches(name, tm.metric_state, jm.metric_state)
        assert not tm.update_called


def test_merge_states_parity():
    jax_m, torch_m = _metrics(jc, jreg), _metrics(tc, treg, device="cpu")
    for name in TOL:
        jm, tm = jax_m[name], torch_m[name]
        js, ts = [], []
        for seed in (1, 2):
            x, y = _inputs(name, seed)
            js.append(jm.update_state(jm.init_state(), jnp.asarray(x), jnp.asarray(y)))
            ts.append(tm.update_state(tm.init_state(), torch.from_numpy(x), torch.from_numpy(y)))
        _assert_state_matches(name, tm.merge_states(*ts), jm.merge_states(*js))


@pytest.mark.parametrize("k", [1, 3])
def test_state_from_jax_round_trip(k):
    jax_m, torch_m = _metrics(jc, jreg), _metrics(tc, treg, device="cpu")
    for name in TOL:
        jm, tm = jax_m[name], torch_m[name]
        js = jm.init_state()
        for seed in range(k):
            x, y = _inputs(name, 20 + seed)
            js = jm.update_state(js, jnp.asarray(x), jnp.asarray(y))
        ts = state_from_jax(tm, _state_np(js))
        _assert_state_matches(name, ts, js)
        for seed in range(k, k + 2):
            x, y = _inputs(name, 20 + seed)
            js = jm.update_state(js, jnp.asarray(x), jnp.asarray(y))
            ts = tm.update_state(ts, torch.from_numpy(x), torch.from_numpy(y))
        _assert_state_matches(name, ts, js)
        _close(name, tm.compute_state(ts), jm.compute_state(js))


def test_state_from_jax_rejects_mismatches():
    tm = tc.MulticlassAccuracy(num_classes=C, device="cpu")
    state = _state_np(jc.MulticlassAccuracy(num_classes=C).init_state())
    with pytest.raises(StateRestoreError, match="missing"):
        state_from_jax(tm, {k: v for k, v in state.items() if k != "tp"})
    with pytest.raises(StateRestoreError) as err:
        state_from_jax(tm, {**state, "tp": state["tp"].astype(np.int64)})
    assert err.value.reason == "dtype" and err.value.leaf == "tp"
    with pytest.raises(StateRestoreError, match="shape"):
        state_from_jax(tm, {**state, "fp": np.zeros(C + 1, np.int32)})
    with pytest.raises(StateRestoreError, match="int32 scalar"):
        state_from_jax(tm, {**state, "_n": np.zeros(2, np.int32)})


def test_state_dict_round_trip():
    tm = tc.MulticlassAUROC(num_classes=C, thresholds=20, device="cpu")
    assert tm.state_dict() == {}  # no leaf is persistent by default
    tm.persistent(True)
    x, y = _inputs("auroc", 3)
    tm.update(torch.from_numpy(x), torch.from_numpy(y))
    sd = tm.state_dict(prefix="m.")
    assert set(sd) == {"m.confmat"} and sd["m.confmat"].dtype == torch.int32
    fresh = tc.MulticlassAUROC(num_classes=C, thresholds=20, device="cpu")
    fresh.load_state_dict(sd, prefix="m.")
    torch.testing.assert_close(fresh.metric_state["confmat"], tm.metric_state["confmat"], rtol=0, atol=0)
    with pytest.raises(StateRestoreError, match="dtype"):
        fresh.load_state_dict({"confmat": sd["m.confmat"].to(torch.int64)})
    with pytest.raises(TorchMetricsUserError, match="shape"):
        fresh.load_state_dict({"confmat": sd["m.confmat"][:3]})
    with pytest.raises(StateRestoreError, match="expects a tensor"):
        fresh.load_state_dict({"confmat": [sd["m.confmat"]]})
    with pytest.warns(UserWarning, match="unknown key"):
        fresh.load_state_dict({**sd, "m.bogus": torch.zeros(1)}, prefix="m.")
    fresh.persistent(True)
    with pytest.warns(UserWarning, match="missing"):
        fresh.load_state_dict({})


def test_pickle_and_clone_round_trip():
    tm = tc.MulticlassAUROC(num_classes=C, thresholds=20, device="cpu")
    x, y = _inputs("auroc", 4)
    tm.update(torch.from_numpy(x), torch.from_numpy(y))
    want = tm.compute()
    for copy in (pickle.loads(pickle.dumps(tm)), tm.clone()):
        assert copy.device == tm.device and copy.thresholds.dtype == torch.float32
        torch.testing.assert_close(copy.compute(), want, rtol=0, atol=0)
        copy.update(torch.from_numpy(x), torch.from_numpy(y))
        assert copy.update_count == 2 and tm.update_count == 1  # independent states
    moved = tm.to("cpu")
    assert moved is tm and tm.metric_state["confmat"].device.type == "cpu"


def test_metric_device_contract():
    if torch.cuda.is_available():
        assert tc.MulticlassAccuracy(num_classes=C).device.type == "cuda"
        assert _entry.entry()[1][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.MulticlassAccuracy(num_classes=C)
        with pytest.raises(RuntimeError, match="CUDA"):
            _entry.entry()
        with pytest.raises(RuntimeError, match="CUDA"):
            treg.MeanSquaredError()
    assert tc.MulticlassAccuracy(num_classes=C, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kwarg", ["sync_on_compute", "jit", "nan_strategy", "approx", "axis_name", "process_group"])
def test_unported_base_kwargs_raise(kwarg):
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        tc.MulticlassAccuracy(num_classes=C, device="cpu", **{kwarg: None})


def test_unknown_kwargs_and_bad_states_raise():
    with pytest.raises(ValueError, match="Unexpected keyword"):
        treg.MeanSquaredError(device="cpu", bogus=1)
    m = Metric(device="cpu")
    with pytest.raises(ValueError, match="must not start"):
        m.add_state("_x", torch.zeros(()))
    with pytest.raises(ValueError, match="start empty"):
        m.add_state("x", [torch.zeros(())])
    with pytest.raises(ValueError, match="value_range"):
        m.add_state("x", torch.zeros(()), value_range=(1.0, 0.0))
    with pytest.raises(ValueError, match="tensor or an empty list"):
        m.add_state("x", "zero")
    m.add_state("x", 0.0, dist_reduce_fx="sum")
    m.add_state("items", [], dist_reduce_fx="cat")
    assert m.init_state()["x"].dtype == torch.float32 and m.init_state()["items"] == ()
    assert m.init_state()["_n"].dtype == torch.int32


def test_compute_with_cache_off():
    tm = treg.MeanSquaredError(device="cpu", compute_with_cache=False)
    tm.update(torch.ones(3), torch.zeros(3))
    assert tm.compute() is not tm.compute()


def _port_modules():
    names = ["torchmetrics_tpu_torch"]
    names += [m.name for m in pkgutil.walk_packages([str(PACKAGE)], prefix="torchmetrics_tpu_torch.")]
    return sorted(names)


def test_port_imports_no_jax_at_run_time():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torchmetrics_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


REST_OF_CLASSIFICATION = ("calibration_error", "hinge", "exact_match", "ranking", "group_fairness", "dice",
                          "fixed_operating_point")


def test_isolation_covers_every_new_module():
    modules = set(_port_modules())
    for name in ("aggregation", "classification.roc", "functional.classification.auroc",
                 "functional.classification.roc", "functional.regression.correlation",
                 "functional.regression.variance", "regression.correlation", "regression.variance",
                 "regression.distribution", "utilities.enums", "utilities.checks", "utilities.formatting",
                 "kernels.calibration", "kernels.ranking",
                 *(f"{pkg}.{m}" for m in REST_OF_CLASSIFICATION for pkg in ("classification", "functional.classification"))):
        assert f"torchmetrics_tpu_torch.{name}" in modules


@pytest.mark.parametrize("source", ["calibration", "ranking"])
def test_kernel_sources_are_plain_cuda_with_a_c_interface(source):
    """The kernels build with nvcc alone and bind through ctypes: no PyTorch, JAX or Python headers."""
    text = (PACKAGE / "csrc" / f"{source}.cu").read_text()
    includes = [line.split()[1] for line in text.splitlines() if line.startswith("#include")]
    assert includes and all(inc.startswith("<cuda") or inc in ("<climits>", "<cstdint>") for inc in includes), includes
    assert f'extern "C" int {source}_' in text
    assert "torchmetrics_tpu/functional/classification/" in text  # names the JAX site it replaces


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not _imported_roots(path) & {"jax", "jaxlib", "torchmetrics_tpu"}, path


@pytest.mark.parametrize("module", _port_modules())
def test_port_doctests(module):
    mod = importlib.import_module(module)
    result = doctest.testmod(mod, optionflags=doctest.NORMALIZE_WHITESPACE, verbose=False)
    assert result.failed == 0, module


def test_top_level_exports():
    assert torchmetrics_tpu_torch.MulticlassAUROC is tc.MulticlassAUROC
    assert set(torchmetrics_tpu_torch.__all__) <= set(dir(torchmetrics_tpu_torch))
