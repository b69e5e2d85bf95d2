"""The port's single-device eval step, twin of ``__graft_entry__.entry()``.

The same four metrics with the same options, through the pure
``init_state -> update_state -> compute_state`` path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
from torchmetrics_tpu_torch.regression import MeanSquaredError
from torchmetrics_tpu_torch.utilities.data import resolve_device

NUM_CLASSES = 10
BATCH = 64


def entry(
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Callable[..., Dict[str, Tensor]], Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """``(eval_step, (probs, target, values, references))``.

    ``eval_step`` updates fresh states of the four metrics from one batch and
    returns their results. The inputs, 64 rows over 10 classes, come from a
    ``torch.Generator`` seeded with 0; they are not the JAX entry's numbers.
    """
    device = resolve_device(device)
    acc = MulticlassAccuracy(num_classes=NUM_CLASSES, average="micro", validate_args=False, device=device)
    f1 = MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", validate_args=False, device=device)
    auroc = MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=20, validate_args=False, device=device)
    mse = MeanSquaredError(device=device)

    def eval_step(probs: Tensor, target: Tensor, values: Tensor, references: Tensor) -> Dict[str, Tensor]:
        """One metric eval step: update states from the batch, compute results."""
        sa = acc.update_state(acc.init_state(), probs, target)
        sf = f1.update_state(f1.init_state(), probs, target)
        su = auroc.update_state(auroc.init_state(), probs, target)
        sm = mse.update_state(mse.init_state(), values, references)
        return {
            "accuracy": acc.compute_state(sa),
            "f1": f1.compute_state(sf),
            "auroc": auroc.compute_state(su),
            "mse": mse.compute_state(sm),
        }

    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn((BATCH, NUM_CLASSES), generator=gen), dim=1)
    target = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen)
    values = torch.randn((BATCH,), generator=gen)
    references = values + 0.1
    return eval_step, tuple(x.to(device) for x in (probs, target, values, references))
