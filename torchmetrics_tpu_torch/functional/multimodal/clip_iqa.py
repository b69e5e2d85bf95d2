"""CLIP-IQA (counterpart of ``torchmetrics_tpu/functional/multimodal/clip_iqa.py``).

For each prompt pair (positive, negative), the softmax over the two anchors' cosine logits gives P(positive). The
prompt table and the scoring are the reference's; the CLIP encoders are pluggable as in
:mod:`~torchmetrics_tpu_torch.functional.multimodal.clip_score`.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
    >>> images = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(123))
    >>> score = clip_image_quality_assessment(images, prompts=("quality",))
    >>> bool(0 <= float(score) <= 1)
    True
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal.clip_score import _images_device, _resolve_clip_encoders, _unit_rows
from torchmetrics_tpu_torch.utilities.compute import _softmax
from torchmetrics_tpu_torch.utilities.precision import full_float32

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _clip_iqa_format_prompts(
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
) -> Tuple[List[str], List[str]]:
    """The prompts' strings, two a pair, and their names: a keyword's own, ``user_defined_<i>`` for a custom pair."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS.keys())} if not custom tuples of strings, got {p}"
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        else:
            if len(p) != 2:
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_list, prompts_names


def _clip_iqa_compute(
    img_features: Tensor,
    anchors: Tensor,
    prompts_names: List[str],
    format_as_dict: bool = True,
) -> Union[Tensor, Dict[str, Tensor]]:
    """P(positive) of each image and prompt: the softmax over each pair of anchor logits ``100 img @ anchors.T``.

    One prompt gives ``probs.squeeze()``; more give a dict by prompt name, or the ``(N, P)`` tensor.
    """
    with full_float32():
        logits_per_image = 100 * img_features @ anchors.T
    probs = _softmax(logits_per_image.reshape(logits_per_image.shape[0], -1, 2), dim=-1)[:, :, 0]
    if len(prompts_names) == 1:
        return probs.squeeze()
    if format_as_dict:
        return {p: probs[:, i] for i, p in enumerate(prompts_names)}
    return probs


def _check_data_range(data_range: float) -> None:
    if not (isinstance(data_range, (int, float)) and data_range > 0):
        raise ValueError("Argument `data_range` should be a positive number.")


def _scaled_images(images: Tensor, data_range: float, device: torch.device) -> Tensor:
    """``images`` as float32 on ``device`` over ``data_range``; raises unless ``(N, 3, H, W)``."""
    images = torch.as_tensor(images, device=device).to(torch.float32) / float(data_range)
    if images.ndim != 4 or images.shape[1] != 3:
        raise ValueError(f"Expected 4D (N, 3, H, W) input, got {tuple(images.shape)}")
    return images


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: str = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    image_encoder: Optional[Callable] = None,
    text_encoder: Optional[Callable] = None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """CLIP-IQA of each image, on the images' device."""
    _check_data_range(data_range)
    prompts_list, prompts_names = _clip_iqa_format_prompts(prompts)
    device = _images_device(images)
    image_encoder, text_encoder = _resolve_clip_encoders(model_name_or_path, image_encoder, text_encoder, device)
    images = _scaled_images(images, data_range, device)
    img_features = _unit_rows(image_encoder(images), device)
    anchors = _unit_rows(text_encoder(prompts_list), device)
    return _clip_iqa_compute(img_features, anchors, prompts_names)
