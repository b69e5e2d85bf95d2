"""Image signal metrics (counterpart of ``torchmetrics_tpu/image/``).

The generative metrics and LPIPS wait for the image backbones.
"""

from torchmetrics_tpu_torch.image.psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from torchmetrics_tpu_torch.image.spectral import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    QualityWithNoReference,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpatialDistortionIndex,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)
from torchmetrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
