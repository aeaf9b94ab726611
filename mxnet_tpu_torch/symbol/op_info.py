"""Per-op input signatures for the symbolic layer (counterpart of
``mxnet_tpu/symbol/op_info.py``, limited to the port's op set): each
op's (argument input names, auxiliary input names). Auxiliary inputs
(BatchNorm's moving statistics) are inputs that are not arguments."""

OP_INPUTS = {
    "FullyConnected": (["data", "weight", "bias"], []),
    "Convolution": (["data", "weight", "bias"], []),
    "conv_s2d_stem": (["data", "weight"], []),
    "BatchNorm": (["data", "gamma", "beta"], ["moving_mean", "moving_var"]),
    "LayerNorm": (["data", "gamma", "beta"], []),
    "Embedding": (["data", "weight"], []),
    "_contrib_SparseEmbedding": (["data", "weight"], []),
    "SoftmaxOutput": (["data", "label"], []),
    "Softmax": (["data", "label"], []),
    "LinearRegressionOutput": (["data", "label"], []),
    "LogisticRegressionOutput": (["data", "label"], []),
    "MAERegressionOutput": (["data", "label"], []),
    "SVMOutput": (["data", "label"], []),
    "CausalSelfAttention": (["data"], []),
    "Activation": (["data"], []),
    "Pooling": (["data"], []),
    "Flatten": (["data"], []),
    "broadcast_add": (["lhs", "rhs"], []),
    "RNN": (["data", "parameters", "state", "state_cell"], []),
    "_rnn_zero_state": (["data"], []),
    "Dropout": (["data"], []),
    "LRN": (["data"], []),
    "SliceChannel": (["data"], []),
}


def op_input_names(op_name):
    """(arg_names, aux_names) for an op; None arg_names means the op
    takes positional inputs only."""
    if op_name in OP_INPUTS:
        return OP_INPUTS[op_name]
    return None, []
