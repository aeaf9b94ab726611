"""The legacy symbolic RNN cells (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``; reference: python/mxnet/rnn/rnn_cell.py).

The cells build ``sym`` graphs, the pre-Gluon API that the bucketing
example is written against. ``FusedRNNCell`` is one ``sym.RNN`` node
(``ops/nn.py``; lstm steps through L1 on the card) holding every
layer's weights as the reference's flat cuDNN-layout vector, with
``unfuse()`` into per-layer cells and ``pack_weights`` /
``unpack_weights`` between the two forms (reference:
rnn_cell.py:536-750). ``begin_state`` derives its zeros from a data
symbol (``_rnn_zero_state``); literal zeros from ``batch_size`` are not
ported (``sym.zeros``).
"""
from __future__ import annotations

import numpy as np

from .. import symbol as sym_mod
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "FusedRNNCell", "RNNCell",
           "LSTMCell", "GRUCell", "SequentialRNNCell", "DropoutCell",
           "BidirectionalCell"]

sym = sym_mod


def _nd(a, like):
    """``a`` (numpy) as an NDArray where ``like`` (an NDArray or a
    tensor) lies, or on the current context."""
    from ..ndarray import NDArray, array
    ctx = like.context if isinstance(like, NDArray) \
        else getattr(like, "device", None)
    return array(a, ctx=ctx)


class RNNParams:
    """Container for cell parameter symbols (reference: rnn_cell.py:36)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract symbolic RNN cell (reference: rnn_cell.py:68)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self.params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, data=None, batch_axis=0, **kwargs):
        """Initial state symbols. With ``data`` (the input sequence
        symbol) shapes derive from its batch dim at bind time —
        ``batch_axis`` names that dim (0 for an (N,C) step or NTC, 1 for
        TNC); with ``batch_size`` they are literal zeros (both
        reference-compatible call styles)."""
        assert not self._modified
        batch_size = kwargs.pop("batch_size", 0)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            shape = info["shape"]
            if data is not None:
                num = shape[0] if len(shape) == 3 else 0
                states.append(sym._rnn_zero_state(
                    data=data, state_size=shape[-1], num=num,
                    batch_axis=batch_axis,
                    name=f"{self._prefix}begin_state_"
                         f"{self._init_counter}"))
            else:
                raise MXNetError(
                    "begin_state needs data= (shape-deriving zeros); "
                    "literal zeros from batch_size= (sym.zeros) are not "
                    "ported")
        return states

    # checkpoint interop: the canonical unpacked format is per-GATE
    # arrays (reference: BaseRNNCell.unpack_weights rnn_cell.py:130) —
    # gate cells split their 4H/3H fused FC weights, FusedRNNCell slices
    # its flat vector to the same names, so the two forms interconvert.
    @staticmethod
    def _np(v):
        if hasattr(v, "asnumpy"):
            return v.asnumpy()
        if hasattr(v, "detach"):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def unpack_weights(self, args):
        if not self._gate_names:
            return dict(args)
        args = dict(args)
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                name = f"{self._prefix}{group}_{kind}"
                if name not in args:
                    continue
                src = args.pop(name)
                full = self._np(src)
                for j, gate in enumerate(self._gate_names):
                    args[f"{self._prefix}{group}{gate}_{kind}"] = \
                        _nd(full[j * h:(j + 1) * h].copy(), src)
        return args

    def pack_weights(self, args):
        if not self._gate_names:
            return dict(args)
        args = dict(args)
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                names = [f"{self._prefix}{group}{gate}_{kind}"
                         for gate in self._gate_names]
                if not all(nm in args for nm in names):
                    continue
                like = args[names[0]]
                args[f"{self._prefix}{group}_{kind}"] = _nd(
                    np.concatenate([self._np(args.pop(nm)) for nm in names],
                                   axis=0), like)
        return args

    def _slice_inputs(self, length, inputs, layout):
        """-> (list of (N,C) symbols per step, merged_or_None)."""
        if isinstance(inputs, (list, tuple)):
            assert len(inputs) == length
            return list(inputs), None
        axis = layout.find("T")
        return list(sym.SliceChannel(inputs, num_outputs=length,
                                     axis=axis, squeeze_axis=True)), inputs

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, merged = self._slice_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(
                data=merged if merged is not None else steps[0],
                batch_axis=layout.find("N") if merged is not None else 0)
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if merge_outputs:
            axis = layout.find("T")
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference: rnn_cell.py:323)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i,f,c,o (reference: rnn_cell.py:378)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        from ..initializer import LSTMBias
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name=f"{name}h2h")
        gates = i2h + h2h
        g = sym.SliceChannel(gates, num_outputs=4,
                             name=f"{name}slice")
        in_gate = sym.Activation(g[0], act_type="sigmoid")
        forget_gate = sym.Activation(g[1], act_type="sigmoid")
        in_transform = sym.Activation(g[2], act_type="tanh")
        out_gate = sym.Activation(g[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r,z,n — cuDNN form: the reset gate scales
    the already-projected h2h_n (reference: rnn_cell.py:459)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name=f"{name}h2h")
        ig = sym.SliceChannel(i2h, num_outputs=3, name=f"{name}i2h_slice")
        hg = sym.SliceChannel(h2h, num_outputs=3, name=f"{name}h2h_slice")
        reset = sym.Activation(ig[0] + hg[0], act_type="sigmoid")
        update = sym.Activation(ig[1] + hg[1], act_type="sigmoid")
        next_h_tmp = sym.Activation(ig[2] + reset * hg[2],
                                    act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (reference: rnn_cell.py:750)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        out = []
        for c in self._cells:
            out.extend(c.state_info)
        return out

    def begin_state(self, **kwargs):
        assert not self._modified
        states = []
        for c in self._cells:
            states.extend(c.begin_state(**kwargs))
        return states

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for c in self._cells:
            n = len(c.state_info)
            inputs, st = c(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, c in enumerate(self._cells):
            n = len(c.state_info)
            st = begin_state[p:p + n] if begin_state is not None else None
            p += n
            inputs, states = c.unroll(
                length, inputs, begin_state=st, layout=layout,
                merge_outputs=None if i < num_cells - 1
                else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout between stacked cells (reference: rnn_cell.py:806)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (reference:
    rnn_cell.py:839). Unroll-only, like the reference."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._cells[0].state_info + self._cells[1].state_info

    def begin_state(self, **kwargs):
        return (self._cells[0].begin_state(**kwargs) +
                self._cells[1].begin_state(**kwargs))

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, merged = self._slice_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(
                data=merged if merged is not None else steps[0],
                batch_axis=layout.find("N") if merged is not None else 0)
        l_cell, r_cell = self._cells
        nl = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(length, steps,
                                        begin_state[:nl], layout="NTC",
                                        merge_outputs=None)
        r_out, r_states = r_cell.unroll(length, list(reversed(steps)),
                                        begin_state[nl:], layout="NTC",
                                        merge_outputs=None)
        r_out = list(reversed(r_out))
        outputs = [sym.Concat(lo, ro, dim=1,
                              name=f"{self._output_prefix}t{t}")
                   for t, (lo, ro) in enumerate(zip(l_out, r_out))]
        if merge_outputs:
            axis = layout.find("T")
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, l_states + r_states


class FusedRNNCell(BaseRNNCell):
    """Whole-depth fused RNN over the sequence: one ``sym.RNN`` node
    holding every layer's weights as the reference's flat cuDNN-layout
    vector (reference: rnn_cell.py:536)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = ["l", "r"] if bidirectional else ["l"]
        from .. import initializer as init
        self._parameter = self.params.get(
            "parameters",
            init=init.FusedRNN(None, num_hidden, num_layers, mode,
                               bidirectional, forget_bias).dumps())

    @property
    def state_info(self):
        b = (1 + self._bidirectional) * self._num_layers
        n = (self._mode == "lstm") + 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped. Please use unroll")

    # -- weight interop -------------------------------------------------------
    def _slice_weights(self, arr, li, lh):
        """Views into the flat cuDNN-layout vector (numpy or torch), keyed
        by the unfused per-gate names (reference: rnn_cell.py:601; the
        layout of ``ops/nn.py`` ``rnn_unpack_params``)."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_i2h" \
                           f"{gate}_weight"
                    if layer > 0:
                        size = b * lh * lh
                        args[name] = arr[p:p + size].reshape((lh, b * lh))
                    else:
                        size = li * lh
                        args[name] = arr[p:p + size].reshape((lh, li))
                    p += size
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_h2h" \
                           f"{gate}_weight"
                    size = lh * lh
                    args[name] = arr[p:p + size].reshape((lh, lh))
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_i2h" \
                           f"{gate}_bias"
                    args[name] = arr[p:p + lh]
                    p += lh
                for gate in gate_names:
                    name = f"{self._prefix}{direction}{layer}_h2h" \
                           f"{gate}_bias"
                    args[name] = arr[p:p + lh]
                    p += lh
        assert p == (arr.size if isinstance(arr, np.ndarray)
                     else arr.numel()), \
            "Invalid parameters size for FusedRNNCell"
        return args

    def _num_input(self, size):
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        return (size // b // h // m
                - (self._num_layers - 1) * (h + b * h + 2) - h - 2)

    def unpack_weights(self, args):
        """fused flat vector -> per-gate arrays (reference:
        rnn_cell.py:639). Values may be NDArray or numpy."""
        args = dict(args)
        src = args.pop(self._parameter.name)
        arr = self._np(src).reshape(-1)
        nargs = self._slice_weights(arr, self._num_input(arr.size),
                                    self._num_hidden)
        args.update({name: _nd(v.copy(), src) for name, v in nargs.items()})
        return args

    def pack_weights(self, args):
        """per-gate arrays -> fused flat vector (reference:
        rnn_cell.py:651)."""
        args = dict(args)
        b = self._bidirectional + 1
        m = self._num_gates
        c = self._gate_names
        h = self._num_hidden
        like = args[f"{self._prefix}l0_i2h{c[0]}_weight"]
        w0 = self._np(like)
        num_input = w0.shape[1]
        total = ((num_input + h + 2) * h * m * b
                 + (self._num_layers - 1) * m * h * (h + b * h + 2) * b)
        arr = np.zeros((total,), dtype=w0.dtype)
        for name, view in self._slice_weights(
                arr, num_input, h).items():
            view[:] = self._np(args.pop(name)).reshape(view.shape)
        args[self._parameter.name] = _nd(arr, like)
        return args

    # -- graph ----------------------------------------------------------------
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            assert len(inputs) == length
            inputs = sym.Concat(
                *[sym.expand_dims(i, axis=0) for i in inputs], dim=0)
            axis = 0
        else:
            axis = layout.find("T")
        if axis == 1:
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state(data=inputs)
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = sym.RNN(data=inputs, parameters=self._parameter,
                      state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional,
                      p=self._dropout,
                      state_outputs=self._get_next_state,
                      mode=self._mode, name=f"{self._prefix}rnn",
                      **states)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = sym.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(sym.SliceChannel(
                outputs, num_outputs=length, axis=axis,
                squeeze_axis=True))
        return outputs, states

    def unfuse(self):
        """-> SequentialRNNCell of per-layer cells sharing the reference
        naming, steppable and weight-compatible through
        pack_weights/unpack_weights (reference: rnn_cell.py:715)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                            activation="relu",
                                            prefix=pre),
            "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                            activation="tanh",
                                            prefix=pre),
            "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre,
                                         forget_bias=self._forget_bias),
            "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout"
                                             f"{i}_"))
        return stack


