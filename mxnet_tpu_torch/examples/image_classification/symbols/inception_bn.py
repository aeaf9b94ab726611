"""Inception-BN / Inception-v2 (Ioffe & Szegedy 2015): GoogLeNet with
BatchNorm after every conv and 5x5 branches factored into double 3x3.

The port's copy of ``examples/image_classification/symbols/inception_bn.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def _conv(x, nf, kernel, stride=(1, 1), pad=(0, 0), name=""):
    x = mx.sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                           pad=pad, no_bias=True, name=f"{name}_conv")
    x = mx.sym.BatchNorm(x, fix_gamma=False, name=f"{name}_bn")
    return mx.sym.Activation(x, act_type="relu", name=f"{name}_relu")


def _inception(x, c1, c3r, c3, cd3r, cd3, cp, pool, name):
    branches = []
    if c1 > 0:
        branches.append(_conv(x, c1, (1, 1), name=f"{name}_1x1"))
    b3 = _conv(x, c3r, (1, 1), name=f"{name}_3x3r")
    branches.append(_conv(b3, c3, (3, 3), pad=(1, 1), name=f"{name}_3x3"))
    bd = _conv(x, cd3r, (1, 1), name=f"{name}_d3x3r")
    bd = _conv(bd, cd3, (3, 3), pad=(1, 1), name=f"{name}_d3x3a")
    branches.append(_conv(bd, cd3, (3, 3), pad=(1, 1),
                          name=f"{name}_d3x3b"))
    bp = mx.sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type=pool)
    if cp > 0:
        bp = _conv(bp, cp, (1, 1), name=f"{name}_proj")
    branches.append(bp)
    return mx.sym.concat(*branches, dim=1)


def _inception_stride(x, c3r, c3, cd3r, cd3, name):
    b3 = _conv(x, c3r, (1, 1), name=f"{name}_3x3r")
    b3 = _conv(b3, c3, (3, 3), (2, 2), (1, 1), name=f"{name}_3x3")
    bd = _conv(x, cd3r, (1, 1), name=f"{name}_d3x3r")
    bd = _conv(bd, cd3, (3, 3), pad=(1, 1), name=f"{name}_d3x3a")
    bd = _conv(bd, cd3, (3, 3), (2, 2), (1, 1), name=f"{name}_d3x3b")
    bp = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max")
    return mx.sym.concat(b3, bd, bp, dim=1)


def get_symbol(num_classes=1000, **kwargs):
    x = mx.sym.Variable("data")
    x = _conv(x, 64, (7, 7), (2, 2), (3, 3), name="conv1")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    x = _conv(x, 64, (1, 1), name="conv2r")
    x = _conv(x, 192, (3, 3), pad=(1, 1), name="conv2")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    x = _inception(x, 64, 64, 64, 64, 96, 32, "avg", "3a")
    x = _inception(x, 64, 64, 96, 64, 96, 64, "avg", "3b")
    x = _inception_stride(x, 128, 160, 64, 96, "3c")
    x = _inception(x, 224, 64, 96, 96, 128, 128, "avg", "4a")
    x = _inception(x, 192, 96, 128, 96, 128, 128, "avg", "4b")
    x = _inception(x, 160, 128, 160, 128, 160, 128, "avg", "4c")
    x = _inception(x, 96, 128, 192, 160, 192, 128, "avg", "4d")
    x = _inception_stride(x, 128, 192, 192, 256, "4e")
    x = _inception(x, 352, 192, 320, 160, 224, 128, "avg", "5a")
    x = _inception(x, 352, 192, 320, 192, 224, 128, "max", "5b")
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7))
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")
