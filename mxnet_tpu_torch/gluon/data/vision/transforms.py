"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference:
python/mxnet/gluon/data/vision/transforms.py).

Each transform takes one image NDArray (HWC for the image-space ones,
CHW after ``ToTensor``) and computes on its device. The random ones draw
as the JAX package's do (Python's ``random`` for the flips and the
colour jitters, numpy's global generator for ``RandomLighting``), so
seeded runs of both packages transform alike; the jitters follow the
JAX package's ``image`` augmenters' math. Not ported yet: ``Resize``,
``CenterCrop`` and ``RandomResizedCrop``, which resample through the
``image`` module (ROADMAP.md A9).
"""
from __future__ import annotations

import math
import random as pyrandom

import numpy as np
import torch

from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]

_GRAY = (0.299, 0.587, 0.114)


def _float(x):
    return x._data.to(torch.float32)


def _const(values, like):
    return torch.as_tensor(np.asarray(values, np.float32), device=like.device)


class Compose(Sequential):
    """Apply transforms in order (reference: transforms.py:33)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """(reference: transforms.py:70)"""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """(H, W, C) uint8 in [0, 255] to (C, H, W) float32 in [0, 1]
    (reference: transforms.py:90)."""

    def hybrid_forward(self, F, x):
        return x.astype("float32").transpose((2, 0, 1)) / 255.0


class Normalize(HybridBlock):
    """``(x - mean) / std`` per channel of a CHW tensor (reference:
    transforms.py:121)."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        d = x._data
        return NDArray((d - _const(self._mean, d)) / _const(self._std, d))


class RandomFlipLeftRight(Block):
    """Mirror an HWC image left-right with probability 0.5 (reference:
    transforms.py:312)."""

    def forward(self, x):
        if pyrandom.random() < 0.5:
            x = NDArray(torch.flip(x._data, [1]))
        return x


class RandomFlipTopBottom(Block):
    """Flip an HWC image top-bottom with probability 0.5 (reference:
    transforms.py:327)."""

    def forward(self, x):
        if pyrandom.random() < 0.5:
            x = NDArray(torch.flip(x._data, [0]))
        return x


def _brightness(x, brightness):
    alpha = 1.0 + pyrandom.uniform(-brightness, brightness)
    return NDArray(_float(x) * alpha)


def _contrast(x, contrast):
    alpha = 1.0 + pyrandom.uniform(-contrast, contrast)
    arr = _float(x)
    gray = (arr * _const(_GRAY, arr)).sum() * (3.0 / arr.numel())
    return NDArray(arr * alpha + gray * (1.0 - alpha))


def _saturation(x, saturation):
    alpha = 1.0 + pyrandom.uniform(-saturation, saturation)
    arr = _float(x)
    gray = (arr * _const(_GRAY, arr)).sum(dim=2, keepdim=True)
    return NDArray(arr * alpha + gray * (1.0 - alpha))


_TYIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]], np.float32)
_ITYIQ = np.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                   [1.0, -1.107, 1.705]], np.float32)


def _hue(x, hue):
    alpha = pyrandom.uniform(-hue, hue)
    u, w = math.cos(alpha * np.pi), math.sin(alpha * np.pi)
    bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], np.float32)
    t = np.dot(np.dot(_ITYIQ, bt), _TYIQ).T
    arr = _float(x)
    return NDArray(arr @ _const(t, arr))


class RandomBrightness(Block):
    """Scale by ``1 + U(-brightness, brightness)``."""

    def __init__(self, brightness):
        super().__init__()
        self._args = brightness

    def forward(self, x):
        return _brightness(x, self._args)


class RandomContrast(Block):
    """Blend with the image's mean gray by ``1 + U(-c, c)``."""

    def __init__(self, contrast):
        super().__init__()
        self._args = contrast

    def forward(self, x):
        return _contrast(x, self._args)


class RandomSaturation(Block):
    """Blend with each pixel's gray by ``1 + U(-s, s)``."""

    def __init__(self, saturation):
        super().__init__()
        self._args = saturation

    def forward(self, x):
        return _saturation(x, self._args)


class RandomHue(Block):
    """Rotate the hue in YIQ space by ``U(-hue, hue) * pi``."""

    def __init__(self, hue):
        super().__init__()
        self._args = hue

    def forward(self, x):
        return _hue(x, self._args)


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitters (those > 0) in a
    random order, then the hue jitter."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = (brightness, contrast, saturation)
        self._hue = hue

    def forward(self, x):
        ts = [(f, a) for f, a in zip((_brightness, _contrast, _saturation),
                                     self._args) if a > 0]
        pyrandom.shuffle(ts)
        for f, a in ts:
            x = f(x, a)
        if self._hue:
            x = _hue(x, self._hue)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (reference: transforms.py:423)."""

    _EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha, size=(3,))
        rgb = np.dot(self._EIGVEC * alpha, self._EIGVAL)
        arr = _float(x)
        return NDArray(arr + _const(rgb, arr))
