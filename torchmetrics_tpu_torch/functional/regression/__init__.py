"""Functional regression metrics of the port."""

from torchmetrics_tpu_torch.functional.regression.basic import (
    cosine_similarity,
    critical_success_index,
    kl_divergence,
    log_cosh_error,
    mean_absolute_error,
    mean_absolute_percentage_error,
    mean_squared_error,
    mean_squared_log_error,
    minkowski_distance,
    symmetric_mean_absolute_percentage_error,
    tweedie_deviance_score,
    weighted_mean_absolute_percentage_error,
)
from torchmetrics_tpu_torch.functional.regression.correlation import (
    concordance_corrcoef,
    kendall_rank_corrcoef,
    pearson_corrcoef,
    spearman_corrcoef,
)
from torchmetrics_tpu_torch.functional.regression.variance import (
    explained_variance,
    r2_score,
    relative_squared_error,
)

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "critical_success_index",
    "explained_variance",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "minkowski_distance",
    "pearson_corrcoef",
    "r2_score",
    "relative_squared_error",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
