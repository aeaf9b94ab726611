"""RNN cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``;
reference: python/mxnet/gluon/rnn/rnn_cell.py).

A cell runs one step; ``unroll`` steps it over a sequence in a Python
loop. The names, the states (``begin_state``), both layouts (NTC and
TNC) and the modifier cells are the JAX package's. The cells are plain
PyTorch through ``nd`` (``FullyConnected`` and ``Activation``): the
fused layers of ``rnn_layer.py`` are the path with the L1 kernel.
``begin_state`` puts its zeros on ``ctx`` (the current context when not
given); ``unroll`` passes the inputs' device.
"""
from __future__ import annotations

from ... import ndarray as F
from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Inputs as a list of per-step (N, C) arrays (``merge`` False), one
    merged tensor (``merge`` True) or as given (None); with the time
    axis, the batch size and the inputs' context (reference:
    rnn_cell.py:55)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        ctx = inputs.context
        if merge is False:
            assert length is None or length == inputs.shape[axis]
            inputs = [x.squeeze(axis=axis) for x in
                      inputs.split(num_outputs=inputs.shape[axis],
                                   axis=axis, squeeze_axis=False)]
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[0]
        ctx = inputs[0].context
        if merge is True:
            inputs = F.concat(*[x.expand_dims(axis=axis) for x in inputs],
                              dim=axis)
    return inputs, axis, batch_size, ctx


class RecurrentCell(Block):
    """Abstract base of RNN cells (reference: rnn_cell.py:93)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-use (reference: rnn_cell.py:110)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """(reference: rnn_cell.py:129)"""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base cell " \
            "cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = {k: v for k, v in (info or {}).items()
                    if not k.startswith("__")}
            if func is None:
                states.append(F.zeros(**info, **kwargs))
            else:
                info.update(kwargs)
                states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` steps (reference:
        rnn_cell.py:173)."""
        self.reset()
        inputs, axis, batch_size, ctx = _format_sequence(length, inputs,
                                                         layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size, ctx=ctx)
        states = begin_state
        outputs = []
        for i in range(length):
            output, new_states = self(inputs[i], states)
            if valid_length is not None:
                # a step past a sequence's length outputs 0 and keeps the
                # state of its last valid step
                mask = (valid_length > float(i)).astype(output.dtype)
                output = output * mask.reshape((-1, 1))
                states = [n * mask.reshape((-1,) + (1,) * (n.ndim - 1)) +
                          s * (1 - mask.reshape((-1,) + (1,) * (n.ndim - 1)))
                          for n, s in zip(new_states, states)]
            else:
                states = new_states
            outputs.append(output)
        if merge_outputs:
            outputs = F.concat(*[o.expand_dims(axis=axis) for o in outputs],
                               dim=axis)
        return outputs, states

    def _get_activation(self, F_, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F_.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """(reference: rnn_cell.py:245)"""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def forward(self, x, *args):
        if any(p._data is None for p in self._reg_params.values()):
            self._finish_deferred(x)
        params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F_, x, *args, **kwargs):
        raise NotImplementedError


class _GateCell(HybridRecurrentCell):
    """A cell with ``gates`` x hidden i2h / h2h weights and biases."""

    _num_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._num_gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * self._num_states

    _num_states = 1

    def infer_shape(self, x):
        g = self._num_gates * self._hidden_size
        self.i2h_weight._infer_shape((g, x.shape[-1]))
        self.h2h_weight._infer_shape((g, self._hidden_size))
        self.i2h_bias._infer_shape((g,))
        self.h2h_bias._infer_shape((g,))

    def _products(self, F_, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                  h2h_bias):
        g = self._num_gates * self._hidden_size
        return (F_.FullyConnected(inputs, i2h_weight, i2h_bias,
                                  num_hidden=g),
                F_.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=g))


class RNNCell(_GateCell):
    """Elman cell (reference: rnn_cell.py:270)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F_, inputs, states, **params):
        i2h, h2h = self._products(F_, inputs, states[0], **params)
        output = self._get_activation(F_, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GateCell):
    """(reference: rnn_cell.py:343) Gates in the order i, f, g, o."""

    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F_, inputs, states, **params):
        i2h, h2h = self._products(F_, inputs, states[0], **params)
        gates = (i2h + h2h).split(num_outputs=4, axis=1)
        in_gate = F_.Activation(gates[0], act_type="sigmoid")
        forget_gate = F_.Activation(gates[1], act_type="sigmoid")
        in_transform = F_.Activation(gates[2], act_type="tanh")
        out_gate = F_.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F_.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GateCell):
    """(reference: rnn_cell.py:437) Gates in the order r, z, n."""

    _num_gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F_, inputs, states, **params):
        prev_h = states[0]
        i2h, h2h = self._products(F_, inputs, prev_h, **params)
        i2h_r, i2h_z, i2h_n = i2h.split(num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = h2h.split(num_outputs=3, axis=1)
        reset_gate = F_.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F_.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F_.Activation(i2h_n + reset_gate * h2h_n,
                                   act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (reference: rnn_cell.py:518)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        num_cells = len(self._children)
        if begin_state is None:
            _, _, batch_size, ctx = _format_sequence(length, inputs, layout,
                                                     None)
            begin_state = self.begin_state(batch_size=batch_size, ctx=ctx)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            state = begin_state[p:p + n]
            p += n
            inputs, state = cell.unroll(
                length, inputs, begin_state=state, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(state)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """(reference: rnn_cell.py:611)"""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F_, inputs, states):
        if self._rate > 0:
            inputs = F_.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, _, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if hasattr(inputs, "shape"):
            return self.hybrid_forward(F, inputs, begin_state or [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that modify another cell (reference:
    rnn_cell.py:672)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F_, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """(reference: rnn_cell.py:731)"""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. Apply zoneout to " \
            "the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F_, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return F_.Dropout(F_.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F_.zeros_like(next_output)
        output = F_.where(mask(self.zoneout_outputs, next_output),
                          next_output, prev_output) \
            if self.zoneout_outputs != 0.0 else next_output
        new_states = [F_.where(mask(self.zoneout_states, new_s), new_s,
                               old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """(reference: rnn_cell.py:800)"""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F_, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """(reference: rnn_cell.py:852) Unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size, ctx = _format_sequence(length, inputs,
                                                         layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size, ctx=ctx)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        outputs = [F.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = F.concat(*[o.expand_dims(axis=axis) for o in outputs],
                               dim=axis)
        return outputs, l_states + r_states
