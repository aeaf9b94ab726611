"""GoogLeNet / Inception-v1 (Szegedy et al. 2014).

The port's copy of ``examples/image_classification/symbols/googlenet.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def _conv(x, nf, kernel, stride=(1, 1), pad=(0, 0), name=""):
    x = mx.sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                           pad=pad, name=f"{name}_conv")
    return mx.sym.Activation(x, act_type="relu", name=f"{name}_relu")


def _inception(x, c1, c3r, c3, c5r, c5, cp, name):
    b1 = _conv(x, c1, (1, 1), name=f"{name}_1x1")
    b3 = _conv(x, c3r, (1, 1), name=f"{name}_3x3r")
    b3 = _conv(b3, c3, (3, 3), pad=(1, 1), name=f"{name}_3x3")
    b5 = _conv(x, c5r, (1, 1), name=f"{name}_5x5r")
    b5 = _conv(b5, c5, (5, 5), pad=(2, 2), name=f"{name}_5x5")
    bp = mx.sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="max")
    bp = _conv(bp, cp, (1, 1), name=f"{name}_proj")
    return mx.sym.concat(b1, b3, b5, bp, dim=1)


# (c1, c3reduce, c3, c5reduce, c5, pool_proj) per module, from the paper
_MODULES = {
    "3a": (64, 96, 128, 16, 32, 32), "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64), "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64), "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def get_symbol(num_classes=1000, **kwargs):
    x = mx.sym.Variable("data")
    x = _conv(x, 64, (7, 7), (2, 2), (3, 3), name="conv1")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    x = _conv(x, 64, (1, 1), name="conv2r")
    x = _conv(x, 192, (3, 3), pad=(1, 1), name="conv2")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for mod in ("3a", "3b"):
        x = _inception(x, *_MODULES[mod], name=f"incep{mod}")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for mod in ("4a", "4b", "4c", "4d", "4e"):
        x = _inception(x, *_MODULES[mod], name=f"incep{mod}")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for mod in ("5a", "5b"):
        x = _inception(x, *_MODULES[mod], name=f"incep{mod}")
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7))
    x = mx.sym.Flatten(x)
    x = mx.sym.Dropout(x, p=0.4)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")
