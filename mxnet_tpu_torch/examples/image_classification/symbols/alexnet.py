"""AlexNet (Krizhevsky et al. 2012), single-tower variant.

The port's copy of ``examples/image_classification/symbols/alexnet.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def _conv(x, name, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    x = mx.sym.Convolution(x, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name=name)
    return mx.sym.Activation(x, act_type="relu", name=name + "_relu")


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    data = mx.sym.Variable("data")
    x = _conv(data, "conv1", 96, (11, 11), (4, 4))
    x = mx.sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, "conv2", 256, (5, 5), pad=(2, 2))
    x = mx.sym.LRN(x, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, "conv3", 384, (3, 3), pad=(1, 1))
    x = _conv(x, "conv4", 384, (3, 3), pad=(1, 1))
    x = _conv(x, "conv5", 256, (3, 3), pad=(1, 1))
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=4096, name="fc6")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Dropout(x, p=0.5)
    x = mx.sym.FullyConnected(x, num_hidden=4096, name="fc7")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Dropout(x, p=0.5)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return mx.sym.SoftmaxOutput(x, name="softmax")
