"""RNN language model (the port's counterpart of
``examples/word_language_model/model.py``; reference:
example/gluon/word_language_model/model.py)."""
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon import nn, rnn


class RNNModel(gluon.Block):
    """Embedding -> multi-layer RNN -> Dense decoder, with optional weight
    tying (reference: model.py:24). The parameter names are the JAX
    example's."""

    def __init__(self, mode, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.5, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(
                vocab_size, num_embed,
                weight_initializer=mx.init.Uniform(0.1))
            if mode in ("rnn_relu", "rnn_tanh"):
                self.rnn = rnn.RNN(num_hidden, num_layers,
                                   activation=mode[4:], dropout=dropout,
                                   input_size=num_embed)
            elif mode == "lstm":
                self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                    input_size=num_embed)
            elif mode == "gru":
                self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                                   input_size=num_embed)
            else:
                raise ValueError(
                    "Invalid mode %s. Options are rnn_relu, rnn_tanh, lstm, "
                    "and gru" % mode)
            if tie_weights:
                self.decoder = nn.Dense(vocab_size, in_units=num_hidden,
                                        params=self.encoder.params)
            else:
                self.decoder = nn.Dense(vocab_size, in_units=num_hidden)
            self.num_hidden = num_hidden

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output.reshape((-1, self.num_hidden)))
        return decoded, hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)
