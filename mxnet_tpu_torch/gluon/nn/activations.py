"""Activation layers (counterpart of
``mxnet_tpu/gluon/nn/activations.py``): ``Activation``, ``LeakyReLU``,
``PReLU``, ``ELU``, ``SELU`` and ``Swish``, over the ``Activation`` and
``LeakyReLU`` ops."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish"]


class Activation(HybridBlock):
    """relu / sigmoid / tanh / softrelu / softsign (reference:
    activations.py:24)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._act_type})"


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere (reference:
    activations.py:55)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._alpha})"


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha``, one value (reference:
    activations.py:88)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as _init
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or _init.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")

    def infer_shape(self, x):
        pass


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` below 0 (reference: activations.py:123)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """(reference: activations.py:152)"""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference: activations.py:176)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
