"""InceptionV3 feature extractor, the pytorch-fid graph (counterpart of
``torchmetrics_tpu/image/backbones/inception.py``).

An ``nn.Module`` with each convolution's inference BatchNorm folded into a
per-channel scale and bias (eps 1e-3), average pools that divide by the
valid elements (``count_include_pad=False``) in the A, C and E blocks, max
pooling in the last E block, and the taps of the JAX package: ``"64"``,
``"192"``, ``"768"`` (spatial means after the first and second max pools and
Mixed_6e), ``"pool"`` (2048), ``"logits"`` and ``"logits_unbiased"``
(1000; the fc layer without its bias). The forward stops at the deepest tap
asked for.

Weights are never downloaded: random-init (He-normal convolutions from a
seeded ``torch.Generator``, fc N(0, 0.01)), or a torchvision/pytorch-fid
``state_dict`` through :func:`load_torch_state_dict`, or the JAX package's
params through ``convert.inception_params_from_jax``. Every convolution and
product runs in full float32 (:func:`~torchmetrics_tpu_torch.image.backbones.full_float32`).

:func:`preprocess` resizes to 299 x 299 as ``jax.image.resize(...,
"bilinear")`` does (:func:`resize_bilinear`: the triangle kernel, widened
when it downsamples, which antialiases) and scales to [-1, 1].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.precision import full_float32

_BN_EPS = 1e-3
NUM_FEATURES = 2048
NUM_LOGITS = 1000

# (name, in_ch, out_ch, kernel, stride, padding) of the stem
_STEM = (
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
)


def _spec_a(cin: int, pool_features: int) -> dict:
    return {"branch1x1": (cin, 64, (1, 1), 1, (0, 0)), "branch5x5_1": (cin, 48, (1, 1), 1, (0, 0)),
            "branch5x5_2": (48, 64, (5, 5), 1, (2, 2)), "branch3x3dbl_1": (cin, 64, (1, 1), 1, (0, 0)),
            "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)), "branch3x3dbl_3": (96, 96, (3, 3), 1, (1, 1)),
            "branch_pool": (cin, pool_features, (1, 1), 1, (0, 0))}


def _spec_b(cin: int) -> dict:
    return {"branch3x3": (cin, 384, (3, 3), 2, (0, 0)), "branch3x3dbl_1": (cin, 64, (1, 1), 1, (0, 0)),
            "branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)), "branch3x3dbl_3": (96, 96, (3, 3), 2, (0, 0))}


def _spec_c(cin: int, c7: int) -> dict:
    return {"branch1x1": (cin, 192, (1, 1), 1, (0, 0)), "branch7x7_1": (cin, c7, (1, 1), 1, (0, 0)),
            "branch7x7_2": (c7, c7, (1, 7), 1, (0, 3)), "branch7x7_3": (c7, 192, (7, 1), 1, (3, 0)),
            "branch7x7dbl_1": (cin, c7, (1, 1), 1, (0, 0)), "branch7x7dbl_2": (c7, c7, (7, 1), 1, (3, 0)),
            "branch7x7dbl_3": (c7, c7, (1, 7), 1, (0, 3)), "branch7x7dbl_4": (c7, c7, (7, 1), 1, (3, 0)),
            "branch7x7dbl_5": (c7, 192, (1, 7), 1, (0, 3)), "branch_pool": (cin, 192, (1, 1), 1, (0, 0))}


def _spec_d(cin: int) -> dict:
    return {"branch3x3_1": (cin, 192, (1, 1), 1, (0, 0)), "branch3x3_2": (192, 320, (3, 3), 2, (0, 0)),
            "branch7x7x3_1": (cin, 192, (1, 1), 1, (0, 0)), "branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
            "branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)), "branch7x7x3_4": (192, 192, (3, 3), 2, (0, 0))}


def _spec_e(cin: int) -> dict:
    return {"branch1x1": (cin, 320, (1, 1), 1, (0, 0)), "branch3x3_1": (cin, 384, (1, 1), 1, (0, 0)),
            "branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)), "branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
            "branch3x3dbl_1": (cin, 448, (1, 1), 1, (0, 0)), "branch3x3dbl_2": (448, 384, (3, 3), 1, (1, 1)),
            "branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)), "branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)),
            "branch_pool": (cin, 192, (1, 1), 1, (0, 0))}


_MIXED = (
    ("Mixed_5b", "a", _spec_a(192, 32)), ("Mixed_5c", "a", _spec_a(256, 64)), ("Mixed_5d", "a", _spec_a(288, 64)),
    ("Mixed_6a", "b", _spec_b(288)), ("Mixed_6b", "c", _spec_c(768, 128)), ("Mixed_6c", "c", _spec_c(768, 160)),
    ("Mixed_6d", "c", _spec_c(768, 160)), ("Mixed_6e", "c", _spec_c(768, 192)), ("Mixed_7a", "d", _spec_d(768)),
    ("Mixed_7b", "e", _spec_e(1280)), ("Mixed_7c", "e", _spec_e(2048)),
)
CONV_NAMES = tuple(n for n, *_ in _STEM) + tuple(f"{m}.{b}" for m, _, spec in _MIXED for b in spec)
TAP_DIMS = {"64": 64, "192": 192, "768": 768, "pool": NUM_FEATURES, "logits": NUM_LOGITS,
            "logits_unbiased": NUM_LOGITS}
_TAP_DEPTH = {"64": 0, "192": 1, "768": 2, "pool": 3, "logits": 3, "logits_unbiased": 3}


class ConvBNReLU(nn.Module):
    """A convolution (no bias), its folded BatchNorm ``y * scale + bias`` and a ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: int, padding: Tuple[int, int]) -> None:
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros((cout, cin, *kernel)), requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: Tensor) -> Tensor:
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        return F.relu(y * self.scale[None, :, None, None] + self.bias[None, :, None, None])


def _avg_pool_3x3(x: Tensor) -> Tensor:
    """3 x 3, stride 1, pad 1, each window divided by its valid elements (pytorch-fid's patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Mixed(nn.Module):
    def __init__(self, kind: str, spec: dict, last: bool = False) -> None:
        super().__init__()
        self.kind, self.last = kind, last
        self.branches = nn.ModuleDict({name: ConvBNReLU(*args) for name, args in spec.items()})

    def _run(self, x: Tensor, *names: str) -> Tensor:
        for name in names:
            x = self.branches[name](x)
        return x

    def forward(self, x: Tensor) -> Tensor:
        run, b = self._run, self.branches
        if self.kind == "a":
            return torch.cat([run(x, "branch1x1"), run(x, "branch5x5_1", "branch5x5_2"),
                              run(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                              run(_avg_pool_3x3(x), "branch_pool")], dim=1)
        if self.kind == "b":
            return torch.cat([run(x, "branch3x3"), run(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
                              F.max_pool2d(x, 3, stride=2)], dim=1)
        if self.kind == "c":
            return torch.cat([run(x, "branch1x1"), run(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
                              run(x, "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4",
                                  "branch7x7dbl_5"),
                              run(_avg_pool_3x3(x), "branch_pool")], dim=1)
        if self.kind == "d":
            return torch.cat([run(x, "branch3x3_1", "branch3x3_2"),
                              run(x, "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"),
                              F.max_pool2d(x, 3, stride=2)], dim=1)
        b3 = run(x, "branch3x3_1")
        bd = run(x, "branch3x3dbl_1", "branch3x3dbl_2")
        # pytorch-fid: the last E block pools by max
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.last else _avg_pool_3x3(x)
        return torch.cat([run(x, "branch1x1"), b["branch3x3_2a"](b3), b["branch3x3_2b"](b3),
                          b["branch3x3dbl_3a"](bd), b["branch3x3dbl_3b"](bd), run(pooled, "branch_pool")], dim=1)


class InceptionV3(nn.Module):
    """The pytorch-fid InceptionV3 on ``(B, 3, H, W)`` in [-1, 1] (299 x 299 as :func:`preprocess` gives)."""

    def __init__(self) -> None:
        super().__init__()
        for name, *args in _STEM:
            self.add_module(name, ConvBNReLU(*args))
        for name, kind, spec in _MIXED:
            self.add_module(name, _Mixed(kind, spec, last=name == "Mixed_7c"))
        self.fc_w = nn.Parameter(torch.zeros((NUM_FEATURES, NUM_LOGITS)), requires_grad=False)
        self.fc_b = nn.Parameter(torch.zeros(NUM_LOGITS), requires_grad=False)

    def conv(self, name: str) -> ConvBNReLU:
        """The convolution of a JAX params key (``"Conv2d_1a_3x3"``, ``"Mixed_5b.branch1x1"``)."""
        if "." in name:
            mixed, branch = name.split(".")
            return getattr(self, mixed).branches[branch]
        return getattr(self, name)

    def forward(self, x: Tensor, features: Sequence[str] = ("pool", "logits")) -> Dict[str, Tensor]:
        depth = max(_TAP_DEPTH[f] for f in features)
        out: Dict[str, Tensor] = {}
        with full_float32():
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, stride=2)
            out["64"] = x.mean(dim=(2, 3))
            if depth > 0:
                x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
                out["192"] = x.mean(dim=(2, 3))
            if depth > 1:
                for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                             "Mixed_6e"):
                    x = getattr(self, name)(x)
                out["768"] = x.mean(dim=(2, 3))
            if depth > 2:
                for name in ("Mixed_7a", "Mixed_7b", "Mixed_7c"):
                    x = getattr(self, name)(x)
                out["pool"] = x.mean(dim=(2, 3))
                out["logits_unbiased"] = out["pool"] @ self.fc_w
                out["logits"] = out["logits_unbiased"] + self.fc_b
        return {k: out[k] for k in features}


def inception_init(seed: int = 0) -> InceptionV3:
    """Random-init weights (CPU): He-normal convolutions (``sqrt(2 / fan_in)``), unit scales, zero biases, fc
    N(0, 0.01), from a ``torch.Generator`` seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    net = InceptionV3()
    with torch.no_grad():
        for name in CONV_NAMES:
            w = net.conv(name).weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen) * np.sqrt(2.0 / fan_in))
        net.fc_w.copy_(torch.randn(net.fc_w.shape, generator=gen) * 0.01)
    return net.eval()


def _array(v: Any) -> Tensor:
    """A state_dict entry (a tensor or an array) as a float32 CPU tensor."""
    return (v.detach().cpu() if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))).to(torch.float32)


def load_torch_state_dict(sd: Dict[str, Any]) -> InceptionV3:
    """An :class:`InceptionV3` from a torchvision/pytorch-fid ``state_dict`` (``Conv2d_1a_3x3.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_mean``, ...; tensors or numpy arrays): each inference BatchNorm (eps 1e-3)
    folds into ``scale = gamma / sqrt(var + eps)``, ``bias = beta - mean * scale``; without ``fc.weight`` the fc
    layer is zero."""
    net = InceptionV3()
    with torch.no_grad():
        for name in CONV_NAMES:
            conv = net.conv(name)
            scale = _array(sd[f"{name}.bn.weight"]) / torch.sqrt(_array(sd[f"{name}.bn.running_var"]) + _BN_EPS)
            conv.weight.copy_(_array(sd[f"{name}.conv.weight"]))
            conv.scale.copy_(scale)
            conv.bias.copy_(_array(sd[f"{name}.bn.bias"]) - _array(sd[f"{name}.bn.running_mean"]) * scale)
        if "fc.weight" in sd:
            net.fc_w.copy_(_array(sd["fc.weight"]).T)
            net.fc_b.copy_(_array(sd["fc.bias"]))
    return net.eval()


def _resize_weights(n_in: int, n_out: int, device: torch.device) -> Tensor:
    """``(n_in, n_out)`` float32 weights of ``jax.image.resize``'s linear (triangle) kernel: sample points at
    ``(j + 0.5) / scale - 0.5``, the kernel widened by ``1 / scale`` when it downsamples (antialiasing), each
    column divided by its sum, columns whose sample lies outside the input zero."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], weights, 0.0)


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """``jax.image.resize(x, (*x.shape[:2], *size), "bilinear")`` on ``(B, C, H, W)`` float32: a product a
    resized axis with :func:`_resize_weights` in full float32, the rows as a batch of ``(P, H) @ (H, W)``, then
    the columns as one ``(B C P, W) @ (W, Q)`` (an axis of the same size stays as it is)."""
    with full_float32():
        if x.shape[2] != size[0]:
            x = torch.matmul(_resize_weights(x.shape[2], size[0], x.device).T, x)
        if x.shape[3] != size[1]:
            x = torch.matmul(x, _resize_weights(x.shape[3], size[1], x.device))
    return x


def preprocess(imgs: Tensor, size: int = 299) -> Tensor:
    """uint8/float ``(B, 3, H, W)`` at pixel scale -> ``size`` x ``size`` by :func:`resize_bilinear`, in [-1, 1]."""
    x = imgs.to(torch.float32) / 255.0
    if x.shape[2] != size or x.shape[3] != size:
        x = resize_bilinear(x, (size, size))
    return x * 2.0 - 1.0


class InceptionFeatureExtractor:
    """Callable ``(B, 3, H, W)`` images -> ``(B, num_features)`` features of one tap: :func:`preprocess` and the
    network. Images in [0, 1] (a whole batch at most 1.5) are taken to pixel scale first.

    Args:
        net: an :class:`InceptionV3`; random-init from ``seed`` without one.
        seed: the random init's seed.
        return_logits: the ``"logits"`` tap.
        feature: the tap, one of ``TAP_DIMS``.
        device: where the network runs (the card by default).
    """

    num_features = NUM_FEATURES

    def __init__(
        self,
        net: Optional[InceptionV3] = None,
        seed: int = 0,
        return_logits: bool = False,
        feature: str = "pool",
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if return_logits:
            feature = "logits"
        if feature not in TAP_DIMS:
            raise ValueError(f"Unknown feature tap {feature!r}; expected one of {sorted(TAP_DIMS)}")
        self.device = resolve_device(device)
        self.net = (net if net is not None else inception_init(seed)).to(self.device).eval()
        self.feature = feature
        self.num_features = TAP_DIMS[feature]

    @classmethod
    def from_torch_state_dict(cls, sd: Dict[str, Any], **kwargs: Any) -> "InceptionFeatureExtractor":
        return cls(net=load_torch_state_dict(sd), **kwargs)

    def __call__(self, imgs: Any) -> Tensor:
        x = torch.as_tensor(imgs, device=self.device).to(torch.float32)
        if bool(x.max() <= 1.5):  # one host read a batch: the whole batch's range
            x = x * 255.0
        with torch.no_grad():
            return self.net(preprocess(x), (self.feature,))[self.feature]

