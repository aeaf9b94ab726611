"""LeNet (reference: example/image-classification/symbols/lenet.py
get_symbol — LeCun et al. 98).

The port's copy of ``examples/image_classification/symbols/lenet.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def get_symbol(num_classes=10, add_stn=False, **kwargs):
    data = mx.sym.Variable("data")
    # first conv
    conv1 = mx.sym.Convolution(data=data, kernel=(5, 5), num_filter=20)
    tanh1 = mx.sym.Activation(data=conv1, act_type="tanh")
    pool1 = mx.sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2),
                           stride=(2, 2))
    # second conv
    conv2 = mx.sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
    tanh2 = mx.sym.Activation(data=conv2, act_type="tanh")
    pool2 = mx.sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2),
                           stride=(2, 2))
    # first fullc (explicit name: fine-tune recipes cut at "flatten0",
    # which must not depend on the process-global auto-name counter)
    flatten = mx.sym.Flatten(data=pool2, name="flatten0")
    fc1 = mx.sym.FullyConnected(data=flatten, num_hidden=500)
    tanh3 = mx.sym.Activation(data=fc1, act_type="tanh")
    # second fullc
    fc2 = mx.sym.FullyConnected(data=tanh3, num_hidden=num_classes)
    lenet = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    return lenet
