"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; reference:
python/mxnet/metric.py — EvalMetric :68, CompositeEvalMetric :233,
Accuracy :363, TopKAccuracy :429, F1 :581, Perplexity :662, MAE/MSE/RMSE
:767-888, CrossEntropy :949, NegativeLogLikelihood :1017,
PearsonCorrelation :1085, Loss :1139, Torch/Caffe :1154, CustomMetric
:1183).

Predictions and labels may be torch tensors (on any device, any float
type), NDArrays or numpy arrays; ``update`` reads them on the host. On
the fused training path ``Module.update_metric`` counts the supported
metrics inside the captured step instead (``metric_device.py``), and
``get`` / ``reset`` fold or drop those counters.
"""
from __future__ import annotations

import math

import numpy
import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np_metric", "create",
           "check_label_shapes"]

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
    """A metric from a name, an instance, a ``feval(label, pred)``
    callable or a list of these."""
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, *args, **kwargs)
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
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
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

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

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

    def __getstate__(self):
        """Pickled without its view of the in-step counters, which are
        folded in first."""
        self._sync_device()
        state = dict(self.__dict__)
        state.pop("_dev_acc", None)
        return state

    def _sync_device(self, keep=True):
        """Fold (``keep``) or drop the in-step counters of the fused
        step (``metric_device.py``); nothing without them."""
        if getattr(self, "_dev_acc", None) is not None:
            from . import metric_device
            if keep:
                metric_device.flush(self)
            else:
                metric_device.discard(self)

    def reset(self):
        self._sync_device(keep=False)
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        """(name, value)."""
        self._sync_device()
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
class F1(EvalMetric):
    """Binary F1 over argmax predictions (``average``: "macro" per
    update, "micro" over all)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


class _BinaryClassificationMetrics:
    """True/false positive and negative counts of a binary classifier."""

    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred = _to_numpy(pred)
        label = _to_numpy(label).astype("int32")
        pred_label = numpy.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if len(numpy.unique(label)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        pred_true = pred_label == 1
        pred_false = 1 - pred_true
        label_true = label == 1
        label_false = 1 - label_true
        self.true_positives += int((pred_true * label_true).sum())
        self.false_positives += int((pred_true * label_false).sum())
        self.false_negatives += int((pred_false * label_true).sum())
        self.true_negatives += int((pred_false * label_false).sum())

    @property
    def precision(self):
        if self.true_positives + self.false_positives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_positives)
        return 0.0

    @property
    def recall(self):
        if self.true_positives + self.false_negatives > 0:
            return float(self.true_positives) / (
                self.true_positives + self.false_negatives)
        return 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (
                self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [(true_pos + false_pos), (true_pos + false_neg),
                 (true_neg + false_pos), (true_neg + false_neg)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg) - (false_pos * false_neg)) / \
            math.sqrt(denom)

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient of a binary classifier."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self.metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self.metrics.matthewscc
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.matthewscc * \
                self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-likelihood of the labels
    (``ignore_label`` rows left out)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            assert label.size == pred.size / pred.shape[-1], \
                f"shape mismatch: {label.shape} vs. {pred.shape}"
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= float(numpy.sum(numpy.log(numpy.maximum(1e-10, probs))))
            num += label.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _as_2d(x):
    """A 1-D array as a column (the elementwise-error metrics' rule)."""
    return x.reshape(x.shape[0], 1) if len(x.shape) == 1 else x


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged over updates."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(_to_numpy(label)), _as_2d(_to_numpy(pred))
            self.sum_metric += float(numpy.abs(label - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error, averaged over updates."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(_to_numpy(label)), _as_2d(_to_numpy(pred))
            self.sum_metric += float(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    """Root mean squared error, averaged over updates."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(_to_numpy(label)), _as_2d(_to_numpy(pred))
            self.sum_metric += float(
                numpy.sqrt(((label - pred) ** 2.0).mean()))
            self.num_inst += 1


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
@_alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """Mean negative log-likelihood of the labels."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, \
                (label.shape[0], num_examples)
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64),
                        numpy.int64(label)]
            self.sum_metric += float((-numpy.log(prob + self.eps)).sum())
            self.num_inst += num_examples


@register
@_alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson correlation of predictions and labels, averaged over
    updates."""

    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, shape=True)
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred).ravel()
            self.sum_metric += float(numpy.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


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


@register
class Torch(Loss):
    """A loss metric named "torch"."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """A loss metric named "caffe"."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or ``(sum_metric, num_inst)``. It always takes the host path:
    the fused step has no in-step rule for it."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator making a ``CustomMetric`` of a numpy function
    ``feval(label, pred)``."""
    def factory(numpy_feval):
        def feval(label, pred):
            return numpy_feval(label, pred)
        feval.__name__ = numpy_feval.__name__
        return CustomMetric(feval, name, allow_extra_outputs)
    return factory


# the reference exposes this decorator as mx.metric.np
np = np_metric
