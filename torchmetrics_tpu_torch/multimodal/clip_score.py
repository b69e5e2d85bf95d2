"""CLIPScore (counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.multimodal import CLIPScore
    >>> image_encoder = lambda imgs: imgs.mean(dim=(2, 3)) @ torch.ones((3, 8))
    >>> text_encoder = lambda rows: torch.stack([torch.as_tensor(r, dtype=torch.float32) for r in rows])
    >>> metric = CLIPScore(image_encoder=image_encoder, text_encoder=text_encoder, device="cpu")
    >>> metric.update(torch.ones((2, 3, 16, 16)), [torch.ones(8), torch.ones(8)])
    >>> round(float(metric.compute()), 4)  # aligned embeddings: the highest score
    100.0
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update, _resolve_clip_encoders


class CLIPScore(Metric):
    """CLIPScore over the pairs seen; float32 sum states: the pairs' scores and their number."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False  # sum states merge; forward encodes each batch once
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(
        self,
        model_name_or_path: str = "openai/clip-vit-large-patch14",
        image_encoder: Optional[Callable] = None,
        text_encoder: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.image_encoder, self.text_encoder = _resolve_clip_encoders(
            model_name_or_path, image_encoder, text_encoder, self.device
        )
        self.add_state("score", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state: State, images: Union[Tensor, List[Tensor]], text: Union[str, List[str]]) -> State:
        score, n_samples = _clip_score_update(images, text, self.image_encoder, self.text_encoder, self.device)
        return {"score": state["score"] + score.sum(), "n_samples": state["n_samples"] + n_samples}

    def _compute(self, state: State) -> Tensor:
        return torch.clamp(state["score"] / state["n_samples"], min=0.0)
