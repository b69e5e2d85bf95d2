"""Functional nominal-association metrics (counterpart of ``torchmetrics_tpu/functional/nominal/``)."""

from torchmetrics_tpu_torch.functional.nominal.contingency import (
    cramers_v,
    cramers_v_matrix,
    pearsons_contingency_coefficient,
    pearsons_contingency_coefficient_matrix,
    theils_u,
    theils_u_matrix,
    tschuprows_t,
    tschuprows_t_matrix,
)
from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import fleiss_kappa

__all__ = [
    "cramers_v",
    "cramers_v_matrix",
    "fleiss_kappa",
    "pearsons_contingency_coefficient",
    "pearsons_contingency_coefficient_matrix",
    "theils_u",
    "theils_u_matrix",
    "tschuprows_t",
    "tschuprows_t_matrix",
]
