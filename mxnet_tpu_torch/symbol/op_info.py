"""Per-op input signatures for the symbolic layer (counterpart of
``mxnet_tpu/symbol/op_info.py``, limited to the port's op set): each
op's (argument input names, auxiliary input names); None names a
variadic op. Auxiliary inputs (BatchNorm's moving statistics) are inputs
that are not arguments. Ops not listed take positional inputs."""

OP_INPUTS = {
    "FullyConnected": (["data", "weight", "bias"], []),
    "Convolution": (["data", "weight", "bias"], []),
    "Deconvolution": (["data", "weight", "bias"], []),
    "conv_s2d_stem": (["data", "weight"], []),
    "BatchNorm": (["data", "gamma", "beta"], ["moving_mean", "moving_var"]),
    "LayerNorm": (["data", "gamma", "beta"], []),
    "InstanceNorm": (["data", "gamma", "beta"], []),
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
    "LeakyReLU": (["data", "gamma"], []),
    "Pooling": (["data"], []),
    "Flatten": (["data"], []),
    "broadcast_add": (["lhs", "rhs"], []),
    "RNN": (["data", "parameters", "state", "state_cell"], []),
    "_rnn_zero_state": (["data"], []),
    "Dropout": (["data"], []),
    "LRN": (["data"], []),
    "SliceChannel": (["data"], []),
    "BatchNorm_v1": (["data", "gamma", "beta"],
                     ["moving_mean", "moving_var"]),
    "softmax_cross_entropy": (["data", "label"], []),
    "Pooling_v1": (["data"], []),
    "Reshape": (["data"], []),
    "Concat": (None, []),
    "add_n": (None, []),
    "ElementWiseSum": (None, []),
    "UpSampling": (None, []),
    "dot": (["lhs", "rhs"], []),
    "batch_dot": (["lhs", "rhs"], []),
    "broadcast_sub": (["lhs", "rhs"], []),
    "broadcast_mul": (["lhs", "rhs"], []),
    "broadcast_div": (["lhs", "rhs"], []),
    "elemwise_add": (["lhs", "rhs"], []),
    "elemwise_sub": (["lhs", "rhs"], []),
    "elemwise_mul": (["lhs", "rhs"], []),
    "elemwise_div": (["lhs", "rhs"], []),
    "CTCLoss": (["data", "label", "data_lengths", "label_lengths"], []),
    "SequenceMask": (["data", "sequence_length"], []),
    "SequenceLast": (["data", "sequence_length"], []),
    "SequenceReverse": (["data", "sequence_length"], []),
    "ROIPooling": (["data", "rois"], []),
    "BilinearSampler": (["data", "grid"], []),
    "SpatialTransformer": (["data", "loc"], []),
    "GridGenerator": (["data"], []),
    "L2Normalization": (["data"], []),
    "where": (["condition", "x", "y"], []),
    "Cast": (["data"], []),
    "BlockGrad": (["data"], []),
    "MakeLoss": (["data"], []),
    "slice": (["data"], []),
    "take": (["a", "indices"], []),
    "one_hot": (["indices"], []),
    "pick": (["data", "index"], []),
    "gather_nd": (["data", "indices"], []),
    "scatter_nd": (["data", "indices"], []),
    "Crop": (None, []),
}


def op_input_names(op_name):
    """(arg_names, aux_names) for an op; None arg_names means the op
    takes positional inputs only."""
    if op_name in OP_INPUTS:
        return OP_INPUTS[op_name]
    return None, []
