"""CLIPScore (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``).

score = 100 * max(cos(image embedding, text embedding), 0), averaged over the pairs. The CLIP model is pluggable:
``image_encoder`` maps ``(B, 3, H, W)`` images to ``(B, D)`` embeddings and ``text_encoder`` a list of strings to
``(B, D)``. A local checkpoint loads through :func:`~torchmetrics_tpu_torch.multimodal.backbones.load_clip_encoders`;
where none is reachable, seeded stand-in encoders keep the metric running, with a warning.

The stand-in image encoder draws its weights from a seeded ``torch.Generator``, where the JAX package's draws with
threefry: the two packages' stand-ins agree only on carried weights
(:func:`~torchmetrics_tpu_torch.convert.clip_image_encoder_from_jax`).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.multimodal.clip_score import clip_score
    >>> image = torch.randint(0, 255, (3, 224, 224), generator=torch.Generator().manual_seed(123)).float()
    >>> score = clip_score(image, "a photo of a cat", model_name_or_path="no-such-checkpoint")
    >>> bool(0 <= float(score) <= 100)
    True
"""

from __future__ import annotations

import math
import os
import zlib
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from torchmetrics_tpu_torch.functional.image.lpips import _same_pad
from torchmetrics_tpu_torch.functional.text.bert import _hash_embedding_model
from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.precision import full_float32
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


class DeterministicImageEncoder(nn.Module):
    """Seeded conv encoder: ``(B, 3, H, W)`` -> ``(B, dim)`` embeddings.

    A stride-2 3 x 3 convolution to 16 channels (XLA's ``"SAME"`` padding: on an even side the one pixel of
    padding goes at the end), a ReLU, the spatial mean and a projection. A batch whose maximum is above 1.5 is
    taken as pixel-scale and divided by 255: one predicate over the whole batch, as in the JAX package.
    """

    def __init__(self, dim: int = 64, seed: int = 7, device: Union[str, torch.device, None] = None) -> None:
        super().__init__()
        self.dim = dim
        gen = torch.Generator().manual_seed(seed)
        device = resolve_device(device)
        self.register_buffer("w1", (torch.randn((16, 3, 3, 3), generator=gen) / math.sqrt(27.0)).to(device))
        self.register_buffer("proj", (torch.randn((16, dim), generator=gen) / 4.0).to(device))

    def forward(self, images: Tensor) -> Tensor:
        x = torch.as_tensor(images, device=self.w1.device).to(torch.float32)
        x = torch.where(x.max() > 1.5, x / 255.0, x)
        with full_float32():
            x = F.relu(F.conv2d(_same_pad(x, 3, 2), self.w1, stride=2))
            return x.mean(dim=(2, 3)) @ self.proj


class DeterministicTextEncoder(nn.Module):
    """Hash-embedding text encoder: ``list[str]`` -> ``(B, dim)`` embeddings.

    Token ids come from a stateless string hash (``zlib.crc32``), not an insertion-order vocabulary, so a caption
    embeds the same whatever was encoded before; the embeddings are
    :func:`~torchmetrics_tpu_torch.functional.text.bert._hash_embedding_model`'s, averaged over the tokens.
    """

    def __init__(self, dim: int = 64, max_length: int = 64, device: Union[str, torch.device, None] = None) -> None:
        super().__init__()
        self.dim = dim
        self.max_length = max_length
        self.device = resolve_device(device)

    @staticmethod
    def _token_id(token: str) -> int:
        return (zlib.crc32(token.encode("utf-8")) % 1_000_003) + 2

    def forward(self, text: Sequence[str]) -> Tensor:
        rows = [[self._token_id(t) for t in caption.lower().split()[: self.max_length]] for caption in text]
        max_len = max((len(r) for r in rows), default=1) or 1
        ids = np.zeros((len(rows), max_len), np.int32)
        mask = np.zeros((len(rows), max_len), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        ids_t, mask_t = torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device)
        emb = _hash_embedding_model(ids_t, mask_t, dim=self.dim)
        return emb.sum(dim=1) / mask_t.sum(dim=1, keepdim=True).clamp_min(1)


_RESOLVED_PAIRS: dict = {}  # (path, device) -> (image encoder, text encoder)


def _resolve_clip_encoders(
    model_name_or_path: str,
    image_encoder: Optional[Callable] = None,
    text_encoder: Optional[Callable] = None,
    device: Union[str, torch.device, None] = None,
) -> Tuple[Callable, Callable]:
    """The encoder pair: explicit encoders win; else a local checkpoint's CLIP model on ``device``; else, only when
    no checkpoint is reachable, the stand-ins, with a warning that the numbers are not CLIP's."""
    if image_encoder is not None and text_encoder is not None:
        return image_encoder, text_encoder
    default_img, default_txt = _default_clip_pair(model_name_or_path, resolve_device(device))
    return (
        image_encoder if image_encoder is not None else default_img,
        text_encoder if text_encoder is not None else default_txt,
    )


def _default_clip_pair(model_name_or_path: str, device: torch.device) -> Tuple[Callable, Callable]:
    key = (model_name_or_path, str(device))
    if key in _RESOLVED_PAIRS:
        return _RESOLVED_PAIRS[key]
    from torchmetrics_tpu_torch.multimodal.backbones.clip import load_clip_encoders

    if os.path.isdir(model_name_or_path):
        # a directory the user named: load it or fail loudly
        pair = load_clip_encoders(model_name_or_path, device)
    else:
        try:
            pair = load_clip_encoders(model_name_or_path, device)
        except (OSError, EnvironmentError, ValueError):
            # the checkpoint is not reachable; any other error propagates
            rank_zero_warn(
                f"CLIP checkpoint {model_name_or_path!r} is not available locally (no download is "
                "possible in this environment). Falling back to deterministic stand-in encoders — "
                "scores will NOT match real CLIP. Pass a local checkpoint directory as "
                "`model_name_or_path`, or explicit `image_encoder`/`text_encoder`, for real scores.",
                UserWarning,
            )
            pair = (DeterministicImageEncoder(device=device), DeterministicTextEncoder(device=device))
    _RESOLVED_PAIRS[key] = pair
    return pair


def _images_device(images: Any) -> torch.device:
    """Where a functional call runs: the device of its image tensor (or of the first of a list of them), else the
    default device."""
    first = images[0] if isinstance(images, (list, tuple)) and len(images) else images
    return first.device if isinstance(first, Tensor) else resolve_device(None)


def _unit_rows(x: Any, device: torch.device) -> Tensor:
    """Rows over their L2 norms (at least 1e-12), as float32 on ``device``."""
    x = torch.as_tensor(x, device=device).to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _clip_score_update(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    image_encoder: Callable,
    text_encoder: Callable,
    device: torch.device,
) -> Tuple[Tensor, int]:
    """Each pair's cosine score times 100, on ``device``, and the number of pairs."""
    if not isinstance(images, (list, tuple)):
        images = torch.as_tensor(images)
        images = [images] if images.ndim == 3 else list(images)
    else:
        images = list(images)
    if not all(torch.as_tensor(i).ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    img_batch = torch.stack([torch.as_tensor(i, device=device).to(torch.float32) for i in images])
    img_features = _unit_rows(image_encoder(img_batch), device)
    txt_features = _unit_rows(text_encoder(text), device)
    return 100 * (img_features * txt_features).sum(dim=-1), len(text)


def clip_score(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, List[str]],
    model_name_or_path: str = "openai/clip-vit-large-patch14",
    image_encoder: Optional[Callable] = None,
    text_encoder: Optional[Callable] = None,
) -> Tensor:
    """CLIPScore: ``max(mean of 100 cos, 0)`` over the pairs, float32, on the images' device."""
    device = _images_device(images)
    image_encoder, text_encoder = _resolve_clip_encoders(model_name_or_path, image_encoder, text_encoder, device)
    score, _ = _clip_score_update(images, text, image_encoder, text_encoder, device)
    return torch.clamp(score.mean(), min=0.0)
