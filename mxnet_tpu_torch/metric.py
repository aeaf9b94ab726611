"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; reference:
python/mxnet/metric.py — EvalMetric :68, CompositeEvalMetric :233,
Accuracy :363, TopKAccuracy :429, CrossEntropy :949, Loss :1139).

Predictions and labels may be torch tensors (on any device, any float
type) or numpy arrays; the metric reads them on the host.
"""
from __future__ import annotations

import numpy
import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Loss", "create", "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*names):
    def wrapper(klass):
        for name in names:
            _METRIC_REGISTRY[name.lower()] = klass
        return klass
    return wrapper


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def create(metric, *args, **kwargs):
    """A metric from a name, an instance or a list of either."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        name = metric.lower()
        if name not in _METRIC_REGISTRY:
            raise ValueError(f"Metric must be in "
                             f"{sorted(set(_METRIC_REGISTRY))}; got {metric}")
        return _METRIC_REGISTRY[name](*args, **kwargs)
    raise TypeError(f"cannot create metric from {metric!r}")


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}")


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return numpy.asarray(x)


class EvalMetric:
    """Base metric: a running ``sum_metric`` over ``num_inst``."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def update_dict(self, label, pred):
        """Update from {name: array} dicts."""
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        """(name, value)."""
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {n: v for n, v in labels.items()
                      if n in self.label_names}
        if self.output_names is not None:
            preds = {n: v for n, v in preds.items()
                     if n in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(_as_list(name))
            values.extend(_as_list(value))
        return (names, values)


@register
@_alias("acc")
class Accuracy(EvalMetric):
    """Classification accuracy (argmax over ``axis``)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _to_numpy(pred_label)
            label = _to_numpy(label)
            if pred_label.ndim > label.ndim or \
                    (pred_label.ndim == label.ndim and
                     pred_label.shape != label.shape):
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            label = label.astype("int32").ravel()
            pred_label = pred_label.astype("int32").ravel()
            check_label_shapes(label, pred_label, shape=True)
            self.sum_metric += int((pred_label == label).sum())
            self.num_inst += len(pred_label)


@register
@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the ``top_k`` predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, \
                "Predictions should be no more than 2 dims"
            pred = numpy.argsort(_to_numpy(pred_label).astype("float32"),
                                 axis=-1)
            label = _to_numpy(label).astype("int32")
            num_samples = pred.shape[0]
            if pred.ndim == 1:
                self.sum_metric += int((pred.ravel() == label.ravel()).sum())
            else:
                num_classes = pred.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += int(
                        (pred[:, num_classes - 1 - j].ravel() ==
                         label.ravel()).sum())
            self.num_inst += num_samples


@register
@_alias("ce")
class CrossEntropy(EvalMetric):
    """Mean cross-entropy of the labels under the predicted
    probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += float((-numpy.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class Loss(EvalMetric):
    """Mean of the raw loss values."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            p = _to_numpy(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size
