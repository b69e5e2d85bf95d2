"""LPIPS (counterpart of ``torchmetrics_tpu/functional/image/lpips.py``).

Learned Perceptual Image Patch Similarity: unit-normalize each layer's
features over channels, weight the squared difference per channel (or take
its channel mean without calibration weights), average over space, sum over
layers. Every ``net_type`` (alex, vgg, squeeze) resolves the backbone of
:mod:`torchmetrics_tpu_torch.image.backbones.lpips_nets`: torchvision
weights from ``TORCHMETRICS_TPU_LPIPS_WEIGHTS_VGG`` / ``..._ALEX`` /
``..._SQUEEZE`` (a ``state_dict`` path) when set, random-init otherwise;
nothing is downloaded. A backbone callable and calibration
``linear_weights`` can be passed; ``DeterministicLPIPSNet`` is an explicit
stand-in.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.lpips import learned_perceptual_image_patch_similarity
    >>> preds = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(42))
    >>> round(float(learned_perceptual_image_patch_similarity(preds, preds, normalize=True)), 4)
    0.0
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.utilities.precision import full_float32
from torchmetrics_tpu_torch.utilities.data import input_device, resolve_device


def _normalize_tensor(x: Tensor, eps: float = 1e-10) -> Tensor:
    """Unit-normalize along channels."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


def _spatial_average(x: Tensor) -> Tensor:
    return x.mean(dim=(2, 3))


def _same_pad(x: Tensor, kernel: int, stride: int) -> Tensor:
    """XLA's ``"SAME"`` padding of the last two dims: the odd pixel of padding at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DeterministicLPIPSNet:
    """Seeded random conv pyramid standing in for a pretrained backbone: ``n_layers`` stride-2 3 x 3
    convolutions (``SAME`` padding, no bias) with ReLUs, each a feature map of ``base_channels * 2**i`` channels.

    ``kernels`` are ``(out, in, 3, 3)`` float32, N(0, 1) / sqrt(9 in) from a ``torch.Generator`` seeded
    ``seed`` (the JAX package's weights through ``convert.deterministic_lpips_from_jax``).
    """

    def __init__(self, n_layers: int = 5, base_channels: int = 16, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.kernels: List[Tensor] = []
        in_ch = 3
        for i in range(n_layers):
            out_ch = base_channels * (2**i)
            self.kernels.append((torch.randn((out_ch, in_ch, 3, 3), generator=gen) / math.sqrt(9.0 * in_ch))
                                .to(self.device))
            in_ch = out_ch

    def __call__(self, x: Any) -> List[Tensor]:
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        feats = []
        with full_float32():
            for w in self.kernels:
                x = F.relu(F.conv2d(_same_pad(x, 3, 2), w, stride=2))
                feats.append(x)
        return feats


_DEFAULT_NETS: Dict[Tuple[str, Optional[str], torch.device], Callable] = {}


def _default_net(net_type: str = "squeeze", device: Optional[Union[str, torch.device]] = None) -> Callable:
    """The backbone of ``net_type`` on ``device``: torchvision weights from the ``TORCHMETRICS_TPU_LPIPS_WEIGHTS_*``
    path when set, random-init otherwise; one a (net, path, device)."""
    from torchmetrics_tpu_torch.image.backbones.lpips_nets import LPIPSBackbone

    device = resolve_device(device)
    path = os.environ.get(f"TORCHMETRICS_TPU_LPIPS_WEIGHTS_{net_type.upper()}")
    key = (net_type, path, device)
    if key not in _DEFAULT_NETS:
        if path:
            _DEFAULT_NETS[key] = LPIPSBackbone.from_torch_state_dict(
                net_type, torch.load(path, map_location="cpu"), device=device)
        else:
            _DEFAULT_NETS[key] = LPIPSBackbone(net=net_type, device=device)
    return _DEFAULT_NETS[key]


def _lpips_from_features(
    feats1: Sequence[Tensor],
    feats2: Sequence[Tensor],
    linear_weights: Optional[Sequence[Tensor]] = None,
) -> Tensor:
    """Sum over layers of the spatially averaged (weighted) squared differences of the normalized features."""
    total = None
    for i, (f1, f2) in enumerate(zip(feats1, feats2)):
        d = (_normalize_tensor(f1) - _normalize_tensor(f2)) ** 2
        if linear_weights is not None:
            w = torch.as_tensor(linear_weights[i], dtype=d.dtype, device=d.device).reshape(1, -1, 1, 1)
            layer = _spatial_average((d * w).sum(dim=1, keepdim=True))[:, 0]
        else:
            layer = _spatial_average(d.mean(dim=1, keepdim=True))[:, 0]
        total = layer if total is None else total + layer
    return total


def learned_perceptual_image_patch_similarity(
    img1: Any,
    img2: Any,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    net: Optional[Callable[[Tensor], List[Tensor]]] = None,
    linear_weights: Optional[Sequence[Tensor]] = None,
) -> Tensor:
    """LPIPS distance of two ``(B, 3, H, W)`` image batches in [-1, 1] (``normalize``: in [0, 1]), at least
    32 x 32. ``net`` overrides the backbone of ``net_type``; a backbone's ``lin_weights`` calibrate it unless
    ``linear_weights`` is given."""
    if net_type not in ("alex", "vgg", "squeeze"):
        raise ValueError(f"Argument `net_type` must be one of 'alex', 'vgg', 'squeeze', but got {net_type}")
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Argument `reduction` must be one of 'mean', 'sum', but got {reduction}")
    if not isinstance(normalize, bool):
        raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
    device = input_device(img1)
    img1 = torch.as_tensor(img1, device=device)
    img2 = torch.as_tensor(img2, device=device)
    if img1.shape != img2.shape or img1.ndim != 4 or img1.shape[1] != 3:
        raise ValueError(
            f"Expected both inputs to be 4D with 3 channels, but got {tuple(img1.shape)} and {tuple(img2.shape)}"
        )
    if img1.shape[2] < 32 or img1.shape[3] < 32:
        # the stride pyramid leaves the deepest maps without pixels below this: their spatial mean is NaN
        raise ValueError(
            f"LPIPS requires spatial dims of at least 32x32, but got {img1.shape[2]}x{img1.shape[3]}"
        )
    if normalize:
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    backbone = net if net is not None else _default_net(net_type, device)
    if linear_weights is None:
        linear_weights = getattr(backbone, "lin_weights", None)
    per_sample = _lpips_from_features(backbone(img1), backbone(img2), linear_weights)
    return per_sample.mean() if reduction == "mean" else per_sample.sum()
