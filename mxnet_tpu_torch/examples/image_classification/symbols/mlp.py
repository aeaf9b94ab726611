"""Multi-layer perceptron (reference: example/image-classification/symbols/
mlp.py get_symbol).

The port's copy of ``examples/image_classification/symbols/mlp.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def get_symbol(num_classes=10, **kwargs):
    data = mx.sym.Variable("data")
    data = mx.sym.Flatten(data=data)
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    act1 = mx.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=64)
    act2 = mx.sym.Activation(data=fc2, name="relu2", act_type="relu")
    fc3 = mx.sym.FullyConnected(data=act2, name="fc3",
                                num_hidden=num_classes)
    mlp = mx.sym.SoftmaxOutput(data=fc3, name="softmax")
    return mlp
