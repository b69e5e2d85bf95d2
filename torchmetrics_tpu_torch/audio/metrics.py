"""Audio metric classes (counterpart of ``torchmetrics_tpu/audio/metrics.py``).

Every class keeps JAX's two float32 scalar states, ``sum_value`` (the sum of
the per-signal values) and ``total`` (their count), both sum-reduced, so a
sync is the bucketed ``all_reduce`` of two floats whatever the batch shape.
Inputs go to the metric's device with 64-bit types narrowed, as JAX takes
them; the functional form does the rest (``functional/audio/``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
    >>> metric = SignalNoiseRatio(device="cpu")
    >>> metric.update(torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 8.0]))
    >>> round(float(metric.compute()), 4)
    18.879
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import METRIC_BASE_KWARGS, Metric, State
from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility


class _AveragedAudioMetric(Metric):
    """Base: the float32 (sum of per-signal values, count) states; a subclass supplies ``_values``."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _accumulate(self, state: State, values: Tensor) -> State:
        new = dict(state)
        new["sum_value"] = state["sum_value"] + values.sum()
        new["total"] = state["total"] + values.numel()
        return new

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._accumulate(state, self._values(self._tensor(preds), self._tensor(target)))

    def _compute(self, state: State) -> Tensor:
        return state["sum_value"] / state["total"]


class SignalNoiseRatio(_AveragedAudioMetric):
    """SNR."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds, target, self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """SI-SNR."""

    is_differentiable = True
    higher_is_better = True

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds, target)


class ComplexScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """C-SI-SNR of complex spectrograms."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds, target, self.zero_mean)


class SignalDistortionRatio(_AveragedAudioMetric):
    """SDR."""

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )


class ScaleInvariantSignalDistortionRatio(_AveragedAudioMetric):
    """SI-SDR.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> metric.update(torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 8.0]))
        >>> round(float(metric.compute()), 4)
        25.5862
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds, target, self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_AveragedAudioMetric):
    """SA-SDR over ``(..., spk, time)``."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)


class PermutationInvariantTraining(_AveragedAudioMetric):
    """PIT: the best permutation's metric of each item, averaged. Keyword arguments that the base takes
    (``METRIC_BASE_KWARGS``, ``device`` among them) go to it; the rest go to ``metric_func``.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_noise_ratio
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> metric = PermutationInvariantTraining(signal_noise_ratio, device="cpu")
        >>> preds = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])
        >>> target = torch.tensor([[[4.1, 5.0, 6.0], [1.0, 2.1, 3.0]]])  # permuted
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        35.2485
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in METRIC_BASE_KWARGS}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.metric_kwargs = kwargs  # the rest go to metric_func

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        best_metric, _ = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.metric_kwargs
        )
        return best_metric


class PerceptualEvaluationSpeechQuality(_AveragedAudioMetric):
    """PESQ; needs the native ``pesq`` package or a ``backend`` callable."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = -0.5
    plot_upper_bound = 4.5

    def __init__(
        self,
        fs: int,
        mode: str,
        n_processes: int = 1,
        backend: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode
        self.backend = backend

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return torch.atleast_1d(
            perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, backend=self.backend)
        )


class ShortTimeObjectiveIntelligibility(_AveragedAudioMetric):
    """STOI, classic or extended."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def _values(self, preds: Tensor, target: Tensor) -> Tensor:
        return torch.atleast_1d(short_time_objective_intelligibility(preds, target, self.fs, self.extended))


class SpeechReverberationModulationEnergyRatio(_AveragedAudioMetric):
    """SRMR; its update takes ``preds`` only."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs

    def _update(self, state: State, preds: Tensor) -> State:
        values = torch.atleast_1d(speech_reverberation_modulation_energy_ratio(self._tensor(preds), self.fs))
        return self._accumulate(state, values)
