"""Functional image metrics (counterpart of ``torchmetrics_tpu/functional/image/``): the signal metrics and
LPIPS."""

from torchmetrics_tpu_torch.functional.image.psnr import (
    peak_signal_noise_ratio,
    peak_signal_noise_ratio_with_blocked_effect,
)
from torchmetrics_tpu_torch.functional.image.spectral import (
    error_relative_global_dimensionless_synthesis,
    quality_with_no_reference,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spatial_correlation_coefficient,
    spatial_distortion_index,
    spectral_angle_mapper,
    spectral_distortion_index,
    universal_image_quality_index,
    visual_information_fidelity,
)
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.tv import image_gradients, total_variation

from torchmetrics_tpu_torch.functional.image.lpips import learned_perceptual_image_patch_similarity

__all__ = [
    "learned_perceptual_image_patch_similarity",
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
