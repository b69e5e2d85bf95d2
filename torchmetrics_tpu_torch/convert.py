"""Carry a JAX metric's state into the port.

Metrics have no weights: what crosses between the two packages is the state
pytree. The JAX side turns its state into numpy first
(``{k: np.asarray(v) for k, v in state.items()}``, list states as lists of
arrays); :func:`state_from_jax` checks it against the port metric's spec and
places it on the metric's device. A synced JAX state loads the same way.
Every state kind of the port carries over: int32 counters and binned curve
states, float32 sums, the cat lists of the exact curves, ``CatMetric`` and
the rank correlations, Pearson's moments, the aggregators' values and
ring buffers (with their ``_n`` counter, which picks the next slot), the
calibration bins (``conf_sum`` float32, ``acc_sum`` and ``count`` int32),
the fairness counters (float32 per group), the hinge and ranking sums,
the exact-match sums or samplewise cat list, retrieval's three cat lists
(indexes, preds, target), PSNR's float32 sums with its int32 pixel count
and target extremes (or its cat lists with ``dim``), PSNR-B's sums, SSIM's
and MS-SSIM's sums or cat lists (with the full maps or contrast
sensitivities), the spectral metrics' cat lists (D-s and QNR with ``ms``,
``pan`` and ``pan_lr``), VIF's sums and total variation's sums or score
list, the segmentation scores' float32 sums and sample counts, nominal
association's float32 ``(C, C)`` table, ``FleissKappa``'s int32 count list,
the clustering metrics' cat lists of labels, or of data and labels, and the
text metrics' states: the error rates' float32 sums (``EditDistance``'s int32
sums or distance list), BLEU's and SacreBLEU's numerator, denominator and
lengths, chrF's count arrays and sentence list, EED's sentence list, TER's and
SQuAD's sums, Perplexity's ``total_log_probs`` and ``count``, BERTScore's
four cat lists of int32 ids and masks, InfoLM's score list and
``DistinctNGrams``' n-gram rows and total, and every sketch leaf of the
``approx`` modes (``torchmetrics_tpu_torch.sketches``): the curves' float32
``score_hist``, calibration's float32 bins, mAP's histograms and counters,
``DistinctNGrams``' int32 HyperLogLog registers and the reservoirs of BLEU,
SacreBLEU and ROUGE with their int32 ``samples_total``.
:func:`collection_states_from_jax` does it for every member state of a
``MetricCollection`` (``{leader name: state}``).

The generative image metrics carry weights: their feature networks'.
:func:`inception_params_from_jax` and :func:`lpips_params_from_jax` build the
port's InceptionV3 and LPIPS backbones from the JAX package's params pytrees
(as numpy: HWIO kernels become OIHW), and
:func:`deterministic_features_from_jax` and
:func:`deterministic_lpips_from_jax` its two seeded stand-ins, so that both
packages run on the same weights; :func:`clip_image_encoder_from_jax` does it
for CLIPScore's and CLIP-IQA's stand-in image encoder (the JAX package draws
its weights with threefry, the port from a ``torch.Generator``). The CLIP
model itself needs no converter: both packages load the same checkpoint
directory. Every tensor of the network must be given,
each of its shape: a missing, extra or misshapen one raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import _N, Metric, State
from torchmetrics_tpu_torch.utilities.data import to_tensor
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError


def state_from_jax(metric: Metric, np_state: Mapping[str, Any]) -> State:
    """The port's state for ``metric`` from a JAX state of numpy arrays.

    The dtypes stay the JAX ones (int32 stays int32, float32 stays float32);
    a list (cat) leaf, a list or tuple of arrays, becomes a tuple of tensors
    of the same dtypes, 64-bit types narrowed as the JAX package runs. A leaf
    whose kind, dtype or shape does not match the port's spec raises
    :class:`StateRestoreError`, as does a missing or unknown leaf.
    """
    expected = set(metric._defaults) | {_N}
    missing, unknown = sorted(expected - set(np_state)), sorted(set(np_state) - expected)
    if missing or unknown:
        raise StateRestoreError(
            f"JAX state does not match {type(metric).__name__}: missing {missing}, unknown {unknown}",
            leaf=(missing or unknown)[0],
            reason="unknown-leaf" if unknown else "missing-leaf",
        )
    counter = np.asarray(np_state[_N])
    if counter.shape != () or counter.dtype != np.int32:
        raise StateRestoreError(
            f"Counter {_N!r} must be an int32 scalar, got {counter.dtype} of shape {counter.shape}",
            leaf=_N,
            reason="dtype",
        )
    state: State = {_N: torch.tensor(counter, device=metric.device)}
    for name in metric._defaults:
        # copies: the port's state never shares memory with the JAX buffers
        value = np_state[name]
        if isinstance(value, (list, tuple)):
            state[name] = metric._validate_leaf(name, [to_tensor(np.array(v), metric.device) for v in value])
        else:
            state[name] = metric._validate_leaf(name, np.array(value))
    return state


def collection_states_from_jax(collection: Any, np_states: Mapping[str, Mapping[str, Any]]) -> Dict[str, State]:
    """The port's ``{leader name: state}`` for a ``MetricCollection`` from the
    JAX collection's per-member numpy states (``init_states``'s keys)."""
    unknown = sorted(set(np_states) - set(collection.keys(keep_base=True)))
    if unknown:
        raise StateRestoreError(f"JAX collection states name unknown members {unknown}", leaf=unknown[0],
                                reason="unknown-leaf")
    return {name: state_from_jax(collection[name], st) for name, st in np_states.items()}


def _weight(params: Mapping[str, Any], key: str, field: str, shape: tuple, hwio: bool = False) -> torch.Tensor:
    """``params[key][field]`` as float32, HWIO kernels as OIHW, of exactly ``shape``."""
    value = torch.as_tensor(np.array(params[key][field], dtype=np.float32))
    if hwio:
        value = value.permute(3, 2, 0, 1)
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"{key}.{field}: shape {tuple(value.shape)} (as the port lays it out), "
                         f"expected {tuple(shape)}")
    return value


def _check_keys(params: Mapping[str, Any], expected: Dict[str, set]) -> None:
    got = {k: set(v) for k, v in params.items()}
    if got != expected:
        missing = sorted(set(expected) - set(got)) + sorted(k for k in expected if k in got and got[k] != expected[k])
        raise ValueError(f"JAX params do not match the network: missing or different {missing}, "
                         f"unknown {sorted(set(got) - set(expected))}")


def inception_params_from_jax(params: Mapping[str, Any]):
    """The port's :class:`~torchmetrics_tpu_torch.image.backbones.inception.InceptionV3` (CPU) from the JAX
    package's InceptionV3 params as numpy: each convolution's ``w`` (HWIO), ``scale`` and ``bias``, and
    ``fc``'s ``w`` (2048, 1000) and ``b``."""
    from torchmetrics_tpu_torch.image.backbones.inception import CONV_NAMES, InceptionV3

    _check_keys(params, {**{n: {"w", "scale", "bias"} for n in CONV_NAMES}, "fc": {"w", "b"}})
    net = InceptionV3()
    with torch.no_grad():
        for name in CONV_NAMES:
            conv = net.conv(name)
            conv.weight.copy_(_weight(params, name, "w", conv.weight.shape, hwio=True))
            conv.scale.copy_(_weight(params, name, "scale", conv.scale.shape))
            conv.bias.copy_(_weight(params, name, "bias", conv.bias.shape))
        net.fc_w.copy_(_weight(params, "fc", "w", net.fc_w.shape))
        net.fc_b.copy_(_weight(params, "fc", "b", net.fc_b.shape))
    return net.eval()


def lpips_params_from_jax(net: str, params: Mapping[str, Any]):
    """The port's LPIPS backbone ``net`` (``"vgg"``, ``"alex"``, ``"squeeze"``; CPU) from the JAX package's
    params as numpy: ``{"features.N": {"w": HWIO, "b": (C,)}}`` (a Fire module's three as
    ``"features.N.squeeze"``, ``".expand1x1"``, ``".expand3x3"``)."""
    from torchmetrics_tpu_torch.image.backbones.lpips_nets import LPIPSNet, conv_names

    names = conv_names(net)
    _check_keys(params, {n: {"w", "b"} for n in names})
    module = LPIPSNet(net)
    with torch.no_grad():
        for name in names:
            conv = module.conv(name)
            conv.weight.copy_(_weight(params, name, "w", conv.weight.shape, hwio=True))
            conv.bias.copy_(_weight(params, name, "b", conv.bias.shape))
    return module.eval()


def _stand_in_weights(arrays: Sequence[Any], shapes: Sequence[tuple], what: str) -> list:
    if len(arrays) != len(shapes):
        raise ValueError(f"{what}: {len(arrays)} tensors given, the network has {len(shapes)}")
    out = []
    for i, (a, shape) in enumerate(zip(arrays, shapes)):
        t = torch.as_tensor(np.array(a, dtype=np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}[{i}]: shape {tuple(t.shape)}, expected {tuple(shape)}")
        out.append(t)
    return out


def deterministic_features_from_jax(kernels: Sequence[Any], proj: Any, dim: Optional[int] = None,
                                    device: Optional[Union[str, torch.device]] = None):
    """The port's ``DeterministicFeatureExtractor`` on the JAX stand-in's ``kernels`` (OIHW, both packages) and
    ``proj (C, dim)``."""
    from torchmetrics_tpu_torch.image.generative import DeterministicFeatureExtractor

    proj = np.asarray(proj)
    extractor = DeterministicFeatureExtractor(dim=dim or proj.shape[1], num_layers=len(kernels), device=device)
    shapes = [tuple(k.shape) for k in extractor.kernels] + [tuple(extractor.proj.shape)]
    *weights, proj_t = _stand_in_weights([*kernels, proj], shapes, "DeterministicFeatureExtractor")
    extractor.kernels = [w.to(extractor.device) for w in weights]
    extractor.proj = proj_t.to(extractor.device)
    return extractor


def deterministic_lpips_from_jax(kernels: Sequence[Any], base_channels: int = 16,
                                 device: Optional[Union[str, torch.device]] = None):
    """The port's ``DeterministicLPIPSNet`` on the JAX stand-in's ``kernels`` (OIHW, both packages)."""
    from torchmetrics_tpu_torch.functional.image.lpips import DeterministicLPIPSNet

    net = DeterministicLPIPSNet(n_layers=len(kernels), base_channels=base_channels, device=device)
    weights = _stand_in_weights(kernels, [tuple(k.shape) for k in net.kernels], "DeterministicLPIPSNet")
    net.kernels = [w.to(net.device) for w in weights]
    return net


def clip_image_encoder_from_jax(w1: Any, proj: Any, device: Optional[Union[str, torch.device]] = None):
    """The port's ``DeterministicImageEncoder`` on the JAX stand-in's ``w1 (16, 3, 3, 3)`` (OIHW, both packages)
    and ``proj (16, dim)``."""
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import DeterministicImageEncoder

    proj = np.asarray(proj)
    encoder = DeterministicImageEncoder(dim=proj.shape[-1], device=device)
    w1_t, proj_t = _stand_in_weights([w1, proj], [tuple(encoder.w1.shape), tuple(encoder.proj.shape)],
                                     "DeterministicImageEncoder")
    encoder.w1.copy_(w1_t)
    encoder.proj.copy_(proj_t)
    return encoder
