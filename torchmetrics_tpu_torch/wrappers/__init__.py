"""Wrapper metrics (counterpart of ``torchmetrics_tpu/wrappers/``)."""

from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from torchmetrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from torchmetrics_tpu_torch.wrappers.feature_share import FeatureShare, NetworkCache
from torchmetrics_tpu_torch.wrappers.minmax import MinMaxMetric
from torchmetrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from torchmetrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from torchmetrics_tpu_torch.wrappers.running import Running
from torchmetrics_tpu_torch.wrappers.tracker import MetricTracker
from torchmetrics_tpu_torch.wrappers.transformations import (
    BinaryTargetTransformer,
    LambdaInputTransformer,
    MetricInputTransformer,
)

__all__ = [
    "BinaryTargetTransformer",
    "BootStrapper",
    "ClasswiseWrapper",
    "FeatureShare",
    "LambdaInputTransformer",
    "MetricInputTransformer",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "NetworkCache",
    "Running",
    "WrapperMetric",
]
