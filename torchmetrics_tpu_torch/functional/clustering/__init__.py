"""Functional clustering metrics (counterpart of ``torchmetrics_tpu/functional/clustering/``)."""

from torchmetrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    expected_mutual_info_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)
from torchmetrics_tpu_torch.functional.clustering.utils import (
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
)

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calinski_harabasz_score",
    "calculate_contingency_matrix",
    "calculate_entropy",
    "calculate_generalized_mean",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "expected_mutual_info_score",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
