"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``, whole;
reference: python/mxnet/gluon/loss.py).

Every loss is a HybridBlock giving one value per sample (the batch axis
kept), with an optional per-sample ``sample_weight``; the formulas and
the op calls are the JAX package's, over the port's ``nd`` ops.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """(reference: loss.py:48)"""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base loss (reference: loss.py:79)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """0.5*(pred-label)^2 (reference: loss.py:114)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    """|pred-label| (reference: loss.py:157)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE with optional pre-sigmoid inputs (reference: loss.py:199)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            # stable form: max(x,0) - x*z + log(1+exp(-|x|))
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label +
                     F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax + CE (reference: loss.py:252)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """Kullback-Leibler divergence (reference: loss.py:318)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist Temporal Classification loss (reference: loss.py:377;
    op src/operator/contrib/ctc_loss.cc)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        assert layout in ("NTC", "TNC")
        assert label_layout in ("NT", "TN")
        self._layout = layout
        self._label_layout = label_layout
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._batch_axis == 1:
            label = label.swapaxes(0, 1)
        # lengths passed by keyword so they bind by name in both the nd and
        # sym paths (a positional None must never shift later inputs left)
        loss = F.CTCLoss(pred, label,
                         data_lengths=pred_lengths,
                         label_lengths=label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smoothed L1 (reference: loss.py:442)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    """max(0, 1 - pred*label) (reference: loss.py:490)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    """max(0, 1 - pred*label)^2 (reference: loss.py:535)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """log(1 + exp(-pred*label)) (reference: loss.py:580)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ("signed", "binary"):
            raise ValueError(
                f"label_format can only be signed or binary, "
                f"received {label_format}")

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """max(|a-p|^2 - |a-n|^2 + margin, 0) (reference: loss.py:629)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)
