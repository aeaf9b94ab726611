"""Fused RNN layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; reference:
python/mxnet/gluon/rnn/rnn_layer.py:32-432).

Each layer keeps per-layer and per-direction i2h / h2h weights under the
reference's names (``l0_i2h_weight``, ``r0_h2h_bias``, ...) and
concatenates them into the flat cuDNN-layout vector of the ``RNN`` op
(``ops/nn.py``), whose lstm mode steps through L1 on the card.
"""
from __future__ import annotations

from ... import ndarray as F
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """(reference: rnn_layer.py:32)"""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        inits = {"i2h_weight": i2h_weight_initializer,
                 "h2h_weight": h2h_weight_initializer,
                 "i2h_bias": i2h_bias_initializer,
                 "h2h_bias": h2h_bias_initializer}
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                for kind, shape in self._shapes(ni).items():
                    name = f"{j}{i}_{kind}"
                    p = self.params.get(name, shape=shape, init=inits[kind],
                                        allow_deferred_init=True)
                    self._reg_params[name] = p
                    object.__setattr__(self, name, p)
            ni = nh * self._dir

    def _shapes(self, ni):
        g = self._gates * self._hidden_size
        return {"i2h_weight": (g, ni), "h2h_weight": (g, self._hidden_size),
                "i2h_bias": (g,), "h2h_bias": (g,)}

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = f"{shape[1] if shape[1] else None} -> " \
            f"{shape[0] // self._gates}"
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}] \
            * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial recurrent states (reference: rnn_layer.py:166); zeros
        on ``ctx`` (the current context when not given)."""
        states = []
        for info in self.state_info(batch_size):
            info = {k: v for k, v in info.items() if not k.startswith("__")}
            if func is None:
                states.append(F.zeros(**info, **kwargs))
            else:
                info.update(kwargs)
                states.append(func(**info))
        return states

    def infer_shape(self, x, *args):
        ni = x.shape[2] if self._layout == "TNC" else x.shape[-1]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                for kind, shape in self._shapes(ni).items():
                    getattr(self, f"{j}{i}_{kind}")._infer_shape(shape)
            ni = self._hidden_size * self._dir

    def forward(self, inputs, states=None):
        """(reference: rnn_layer.py:183) Without ``states``, zeros on the
        inputs' device, and only the output is returned."""
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if hasattr(states, "shape"):
            states = [states]
        if any(p._data is None for p in self._reg_params.values()):
            self._finish_deferred(inputs)
        params = {k: p.data() for k, p in self._reg_params.items()}
        out = self._forward_kernel(inputs, states, params)
        return out[0] if skip_states else out

    def _flat_params(self, params):
        """The per-layer params in the cuDNN layout: every layer's
        weights, then every layer's biases (rnn-inl.h)."""
        dirs = ["l", "r"][:self._dir]
        order = [params[f"{j}{i}_{g}_weight"]
                 for i in range(self._num_layers) for j in dirs
                 for g in ("i2h", "h2h")]
        order += [params[f"{j}{i}_{g}_bias"]
                  for i in range(self._num_layers) for j in dirs
                  for g in ("i2h", "h2h")]
        return F.concat(*[p.reshape((-1,)) for p in order], dim=0)

    def _forward_kernel(self, inputs, states, params):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        outputs = F.RNN(inputs, self._flat_params(params), *states,
                        state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True, mode=self._mode)
        outputs, states = outputs[0], list(outputs[1:])
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        return outputs, states


class RNN(_RNNLayer):
    """Elman RNN with relu or tanh (reference: rnn_layer.py:244)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """(reference: rnn_layer.py:318)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """(reference: rnn_layer.py:398)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
