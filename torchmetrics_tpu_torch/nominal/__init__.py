"""Nominal-association metrics (counterpart of ``torchmetrics_tpu/nominal/``)."""

from torchmetrics_tpu_torch.nominal.nominal import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = [
    "CramersV",
    "FleissKappa",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
