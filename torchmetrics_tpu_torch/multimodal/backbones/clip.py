"""Real CLIP encoders for CLIPScore and CLIP-IQA (counterpart of ``torchmetrics_tpu/multimodal/backbones/clip.py``).

A local checkpoint directory (or a warm HuggingFace cache) loads through transformers' torch ``CLIPModel``,
``CLIPTokenizer`` and ``CLIPImageProcessor`` (:func:`~torchmetrics_tpu_torch.utilities.imports.hf_local_kwargs`:
nothing is downloaded). The JAX package loads the same directory through ``FlaxCLIPModel``, so both hold the same
weights. As there, the processor runs on the host on lists of CHW arrays and caption strings, and the features run
on the device: the model sits on the metric's device in ``eval()``, its attention in the eager form, and every
product and convolution of it runs in full float32 under ``torch.no_grad()``
(:func:`~torchmetrics_tpu_torch.utilities.precision.full_float32`: cuDNN's and cuBLAS's TF32 would move the
card's features off the CPU's). The features are the projections of the towers' pooled outputs, what
``get_image_features`` and ``get_text_features`` return.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.precision import full_float32
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_CLIP_CACHE: dict = {}  # (path, device) -> (image encoder, text encoder)
_MAX_WORKERS = 8  # host threads of the image processor a call


class _CLIPPreprocessor:
    """Tokenizer and image processor behind one processor call, built from ``CLIPTokenizer`` and
    ``CLIPImageProcessor`` themselves: ``CLIPProcessor`` can resolve to a torchvision-backed fast image processor."""

    def __init__(self, tokenizer: Any, image_processor: Any) -> None:
        self.tokenizer = tokenizer
        self.image_processor = image_processor

    def __call__(self, text=None, images=None, return_tensors="np", padding=True):
        out: dict = {}
        if text is not None:
            out.update(self.tokenizer(list(text), return_tensors=return_tensors, padding=padding))
        if images is not None:
            out.update(self.image_processor(images=images, return_tensors=return_tensors))
        return out


def _load_clip(model_name_or_path: str, device: torch.device) -> Tuple[Any, _CLIPPreprocessor]:
    """``(CLIPModel on device, preprocessor)`` from a local directory or the local cache (``OSError`` when the
    checkpoint is not there)."""
    from transformers import CLIPImageProcessor, CLIPModel, CLIPTokenizer

    from torchmetrics_tpu_torch.utilities.imports import hf_local_kwargs

    kwargs = hf_local_kwargs()
    model = CLIPModel.from_pretrained(model_name_or_path, attn_implementation="eager", **kwargs).to(device).eval()
    processor = _CLIPPreprocessor(
        CLIPTokenizer.from_pretrained(model_name_or_path, **kwargs),
        CLIPImageProcessor.from_pretrained(model_name_or_path, **kwargs),
    )
    return model, processor


class CLIPImageEncoder:
    """``(B, 3, H, W)`` images -> ``(B, D)`` CLIP image-projection features.

    Each image goes through the checkpoint's image processor on the host (resize, crop, rescale, normalize), as a
    float32 CHW array as the JAX package passes it, the images spread over up to 8 threads (the same pixels as
    one call); the vision tower and its projection run on the model's device.
    """

    def __init__(self, model: Any, processor: Any) -> None:
        self.model = model
        self.processor = processor
        self.device = next(model.parameters()).device

    def _pixel_values(self, imgs: List[np.ndarray]) -> np.ndarray:
        """The processor's pixels of each image, in order: the images cut into one run a worker thread (PIL's
        resize and numpy's passes release the GIL), each image processed alone as in one call."""
        workers = min(len(imgs), os.cpu_count() or 1, _MAX_WORKERS)
        if workers <= 1:
            return self.processor(images=imgs, return_tensors="np")["pixel_values"]
        runs = [imgs[i::workers] for i in range(workers)]
        with ThreadPoolExecutor(workers) as pool:
            parts = list(pool.map(lambda run: self.processor(images=run, return_tensors="np")["pixel_values"], runs))
        out = np.empty((len(imgs), *parts[0].shape[1:]), parts[0].dtype)
        for i, part in enumerate(parts):
            out[i::workers] = part
        return out

    def __call__(self, images: Tensor) -> Tensor:
        imgs = list(torch.as_tensor(images).detach().to("cpu", torch.float32).numpy())
        pixel_values = torch.from_numpy(self._pixel_values(imgs)).to(self.device)
        with torch.no_grad(), full_float32():
            pooled = self.model.vision_model(pixel_values=pixel_values).pooler_output
            return self.model.visual_projection(pooled)


class CLIPTextEncoder:
    """``list[str]`` -> ``(B, D)`` CLIP text-projection features.

    Tokenizes on the host with the checkpoint's tokenizer, truncates to the text tower's
    ``max_position_embeddings`` with the reference's warning, and runs the text tower and its projection on the
    model's device.
    """

    def __init__(self, model: Any, processor: Any) -> None:
        self.model = model
        self.processor = processor
        self.device = next(model.parameters()).device

    def __call__(self, text: Sequence[str]) -> Tensor:
        processed = self.processor(text=list(text), return_tensors="np", padding=True)
        input_ids = processed["input_ids"]
        attention_mask = processed["attention_mask"]
        max_pos = self.model.config.text_config.max_position_embeddings
        if attention_mask.shape[-1] > max_pos:
            rank_zero_warn(
                f"Encountered caption longer than max_position_embeddings={max_pos}. "
                "Will truncate captions to this length. If longer captions are needed, "
                "initialize argument `model_name_or_path` with a model that supports longer sequences.",
                UserWarning,
            )
            input_ids = input_ids[..., :max_pos]
            attention_mask = attention_mask[..., :max_pos]
        ids = torch.from_numpy(input_ids).to(self.device, torch.int64)
        mask = torch.from_numpy(attention_mask).to(self.device, torch.int64)
        with torch.no_grad(), full_float32():
            pooled = self.model.text_model(input_ids=ids, attention_mask=mask).pooler_output
            return self.model.text_projection(pooled)


def load_clip_encoders(
    model_name_or_path: str, device: Union[str, torch.device, None] = None
) -> Tuple[Callable, Callable]:
    """``(image_encoder, text_encoder)`` backed by a real CLIP checkpoint on ``device`` (CUDA when None).

    Cached per path and device, so that CLIPScore and CLIP-IQA built from the same checkpoint on one device share
    one model.
    """
    device = resolve_device(device)
    key = (model_name_or_path, str(device))
    if key not in _CLIP_CACHE:
        model, processor = _load_clip(model_name_or_path, device)
        _CLIP_CACHE[key] = (CLIPImageEncoder(model, processor), CLIPTextEncoder(model, processor))
    return _CLIP_CACHE[key]
