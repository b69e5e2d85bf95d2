"""Image metrics (counterpart of ``torchmetrics_tpu/image/``): the signal metrics, and the generative metrics
and LPIPS on the backbones of :mod:`torchmetrics_tpu_torch.image.backbones`."""

from torchmetrics_tpu_torch.image.generative import (
    DeterministicFeatureExtractor,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MemorizationInformedFrechetInceptionDistance,
    PerceptualPathLength,
)
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
    "DeterministicFeatureExtractor",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PerceptualPathLength",
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
