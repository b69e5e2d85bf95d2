"""CLIP-IQA (counterpart of ``torchmetrics_tpu/multimodal/clip_iqa.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment
    >>> metric = CLIPImageQualityAssessment(prompts=("quality",), device="cpu")
    >>> metric.update(torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(123)))
    >>> bool(0 <= float(metric.compute()) <= 1)
    True
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import (
    _check_data_range,
    _clip_iqa_compute,
    _clip_iqa_format_prompts,
    _scaled_images,
)
from torchmetrics_tpu_torch.functional.multimodal.clip_score import _resolve_clip_encoders, _unit_rows
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA: the prompts' anchors embedded once at init on the metric's device, the images' unit features
    kept as a cat state."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False  # a cat state merges; forward encodes each batch once
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    _device_attrs = ("anchors",)

    def __init__(
        self,
        model_name_or_path: str = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        image_encoder: Optional[Callable] = None,
        text_encoder: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_data_range(data_range)
        self.data_range = data_range
        prompts_list, self.prompts_names = _clip_iqa_format_prompts(prompts)
        self.image_encoder, text_encoder = _resolve_clip_encoders(
            model_name_or_path, image_encoder, text_encoder, self.device
        )
        self.anchors = _unit_rows(text_encoder(prompts_list), self.device)
        self.add_state("img_features", [], dist_reduce_fx="cat")

    def _update(self, state: State, images: Tensor) -> State:
        feats = _unit_rows(self.image_encoder(_scaled_images(images, self.data_range, self.device)), self.device)
        return {"img_features": state["img_features"] + (feats,)}

    def _compute(self, state: State) -> Union[Tensor, Dict[str, Tensor]]:
        return _clip_iqa_compute(dim_zero_cat(state["img_features"]), self.anchors, self.prompts_names)
