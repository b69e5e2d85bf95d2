"""VGG16, AlexNet and SqueezeNet1.1 feature pyramids for LPIPS (counterpart of
``torchmetrics_tpu/image/backbones/lpips_nets.py``).

Each backbone is an ``nn.Module`` run as the JAX package's op list, and
yields the canonical LPIPS taps:

* VGG16: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (64/128/256/512/512 ch);
* AlexNet: relu1 .. relu5 (64/192/384/256/256 ch);
* SqueezeNet1.1: the 7 slice ends of the lpips package (64 .. 512 ch), its
  max pools in ``ceil_mode``.

Weights are random-init (He-normal, zero bias, from a seeded
``torch.Generator``), a torchvision ``state_dict`` in the ``features.N``
layout (:func:`load_torch_state_dict`), or the JAX package's params through
``convert.lpips_params_from_jax``; nothing is downloaded. Convolutions run
in full float32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch.image.backbones.inception import _array
from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.precision import full_float32

# op lists: ("conv", features index, stride, pad), ("relu",), ("maxpool", window, stride), ("maxpool_ceil", window,
# stride), ("fire", features index), ("tap",): an LPIPS feature output
_VGG16_OPS: Tuple[Tuple, ...] = tuple(
    [("conv", 0, 1, 1), ("relu",), ("conv", 2, 1, 1), ("relu",), ("tap",), ("maxpool", 2, 2)]
    + [("conv", 5, 1, 1), ("relu",), ("conv", 7, 1, 1), ("relu",), ("tap",), ("maxpool", 2, 2)]
    + [("conv", 10, 1, 1), ("relu",), ("conv", 12, 1, 1), ("relu",), ("conv", 14, 1, 1), ("relu",), ("tap",),
       ("maxpool", 2, 2)]
    + [("conv", 17, 1, 1), ("relu",), ("conv", 19, 1, 1), ("relu",), ("conv", 21, 1, 1), ("relu",), ("tap",),
       ("maxpool", 2, 2)]
    + [("conv", 24, 1, 1), ("relu",), ("conv", 26, 1, 1), ("relu",), ("conv", 28, 1, 1), ("relu",), ("tap",)]
)
# (features index, cin, cout, kernel, stride, pad)
_VGG16_CONVS = (
    (0, 3, 64, 3, 1, 1), (2, 64, 64, 3, 1, 1), (5, 64, 128, 3, 1, 1), (7, 128, 128, 3, 1, 1),
    (10, 128, 256, 3, 1, 1), (12, 256, 256, 3, 1, 1), (14, 256, 256, 3, 1, 1),
    (17, 256, 512, 3, 1, 1), (19, 512, 512, 3, 1, 1), (21, 512, 512, 3, 1, 1),
    (24, 512, 512, 3, 1, 1), (26, 512, 512, 3, 1, 1), (28, 512, 512, 3, 1, 1),
)
VGG16_CHANNELS = (64, 128, 256, 512, 512)

_ALEXNET_OPS: Tuple[Tuple, ...] = (
    ("conv", 0, 4, 2), ("relu",), ("tap",), ("maxpool", 3, 2),
    ("conv", 3, 1, 2), ("relu",), ("tap",), ("maxpool", 3, 2),
    ("conv", 6, 1, 1), ("relu",), ("tap",),
    ("conv", 8, 1, 1), ("relu",), ("tap",),
    ("conv", 10, 1, 1), ("relu",), ("tap",),
)
_ALEXNET_CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1), (8, 384, 256, 3, 1, 1),
                  (10, 256, 256, 3, 1, 1))
ALEXNET_CHANNELS = (64, 192, 384, 256, 256)

# (features index) -> (cin, squeeze_ch, expand_ch): a Fire module's output is 2 * expand_ch
_SQUEEZE_FIRES = {3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128), 9: (256, 48, 192),
                  10: (384, 48, 192), 11: (384, 64, 256), 12: (512, 64, 256)}
_SQUEEZE_OPS: Tuple[Tuple, ...] = (
    ("conv", 0, 2, 0), ("relu",), ("tap",),
    ("maxpool_ceil", 3, 2), ("fire", 3), ("fire", 4), ("tap",),
    ("maxpool_ceil", 3, 2), ("fire", 6), ("fire", 7), ("tap",),
    ("maxpool_ceil", 3, 2), ("fire", 9), ("tap",),
    ("fire", 10), ("tap",),
    ("fire", 11), ("tap",),
    ("fire", 12), ("tap",),
)
_SQUEEZE_CONVS = ((0, 3, 64, 3, 2, 0),)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)

_NETS = {
    "vgg": (_VGG16_OPS, _VGG16_CONVS, VGG16_CHANNELS),
    "vgg16": (_VGG16_OPS, _VGG16_CONVS, VGG16_CHANNELS),
    "alex": (_ALEXNET_OPS, _ALEXNET_CONVS, ALEXNET_CHANNELS),
    "squeeze": (_SQUEEZE_OPS, _SQUEEZE_CONVS, SQUEEZE_CHANNELS),
}
_FIRE_PARTS = ("squeeze", "expand1x1", "expand3x3")

# LPIPS ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSNet(nn.Module):
    """One backbone's convolutions, keyed by their ``features`` index (a Fire module's three by
    ``"{index}.{part}"``), run as the op list of ``net``."""

    def __init__(self, net: str) -> None:
        super().__init__()
        if net not in _NETS:
            raise ValueError(f"Unknown LPIPS backbone {net!r}; expected one of {sorted(_NETS)}")
        self.net = net
        ops, convs, _ = _NETS[net]
        self.convs = nn.ModuleDict()
        for idx, cin, cout, k, stride, pad in convs:
            self.convs[str(idx)] = nn.Conv2d(cin, cout, k, stride=stride, padding=pad)
        if net == "squeeze":
            for idx, (cin, sq, ex) in _SQUEEZE_FIRES.items():
                self.convs[str(idx)] = nn.ModuleDict({
                    "squeeze": nn.Conv2d(cin, sq, 1), "expand1x1": nn.Conv2d(sq, ex, 1),
                    "expand3x3": nn.Conv2d(sq, ex, 3, padding=1)})
        self.requires_grad_(False)

    def conv(self, name: str) -> nn.Conv2d:
        """The convolution of a JAX params key (``"features.3"``, ``"features.3.squeeze"``)."""
        parts = name.split(".")[1:]
        mod = self.convs[parts[0]]
        return mod[parts[1]] if len(parts) > 1 else mod

    def forward(self, x: Tensor) -> List[Tensor]:
        taps: List[Tensor] = []
        with full_float32():
            for op in _NETS[self.net][0]:
                if op[0] == "conv":
                    x = self.convs[str(op[1])](x)
                elif op[0] == "relu":
                    x = F.relu(x)
                elif op[0] == "maxpool":
                    x = F.max_pool2d(x, op[1], stride=op[2])
                elif op[0] == "maxpool_ceil":
                    x = F.max_pool2d(x, op[1], stride=op[2], ceil_mode=True)
                elif op[0] == "fire":
                    fire = self.convs[str(op[1])]
                    sq = F.relu(fire["squeeze"](x))
                    x = torch.cat([F.relu(fire["expand1x1"](sq)), F.relu(fire["expand3x3"](sq))], dim=1)
                else:
                    taps.append(x)
        return taps


def conv_names(net: str) -> List[str]:
    """The JAX params keys of a backbone's convolutions, in the JAX package's order."""
    names = [f"features.{idx}" for idx, *_ in _NETS[net][1]]
    if net == "squeeze":
        names += [f"features.{idx}.{part}" for idx in _SQUEEZE_FIRES for part in _FIRE_PARTS]
    return names


def net_init(net: str, seed: int = 0) -> LPIPSNet:
    """He-normal random weights (``sqrt(2 / fan_in)``) and zero biases from a ``torch.Generator`` (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    module = LPIPSNet(net)
    with torch.no_grad():
        for name in conv_names(net):
            conv = module.conv(name)
            fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * np.sqrt(2.0 / fan_in))
            conv.bias.zero_()
    return module.eval()


def load_torch_state_dict(net: str, sd: Dict[str, Any]) -> LPIPSNet:
    """An :class:`LPIPSNet` from a torchvision vgg16/alexnet/squeezenet1_1 ``state_dict`` (``features.N.weight``,
    ``features.N.bias``; tensors or numpy arrays)."""
    module = LPIPSNet(net)
    with torch.no_grad():
        for name in conv_names(net):
            conv = module.conv(name)
            conv.weight.copy_(_array(sd[f"{name}.weight"]))
            conv.bias.copy_(_array(sd[f"{name}.bias"]))
    return module.eval()


def scaling_layer(x: Tensor) -> Tensor:
    """LPIPS input normalization of [-1, 1] images: ``(x - shift) / scale``."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    return (x - shift) / scale


class LPIPSBackbone:
    """Callable ``(B, 3, H, W)`` in [-1, 1] -> the list of tap feature maps, the LPIPS interface.

    ``lin_weights``: a ``(C,)`` calibration vector a layer (the learned 1 x 1 ``lin`` convolutions); None is the
    unweighted ("baseline") mode.
    """

    def __init__(
        self,
        net: str = "vgg",
        module: Optional[LPIPSNet] = None,
        lin_weights: Optional[Sequence[Any]] = None,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if net not in _NETS:
            raise ValueError(f"Unknown LPIPS backbone {net!r}; expected one of {sorted(_NETS)}")
        self.net = net
        self.channels = _NETS[net][2]
        self.device = resolve_device(device)
        self.module = (module if module is not None else net_init(net, seed)).to(self.device)
        self.lin_weights = None if lin_weights is None else [
            torch.as_tensor(w, dtype=torch.float32, device=self.device) for w in lin_weights]

    @classmethod
    def from_torch_state_dict(cls, net: str, sd: Dict[str, Any], **kwargs: Any) -> "LPIPSBackbone":
        return cls(net=net, module=load_torch_state_dict(net, sd), **kwargs)

    def __call__(self, x: Any) -> List[Tensor]:
        with torch.no_grad():
            return self.module(scaling_layer(torch.as_tensor(x, device=self.device).to(torch.float32)))
