"""Inception-v3 (Szegedy et al. 2015), 299x299 input.

The port's copy of ``examples/image_classification/symbols/inception_v3.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def _conv(x, nf, kernel, stride=(1, 1), pad=(0, 0), name=""):
    x = mx.sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                           pad=pad, no_bias=True, name=name + "_conv")
    x = mx.sym.BatchNorm(x, eps=0.001, name=name + "_bn")
    return mx.sym.Activation(x, act_type="relu")


def _branch(x, name, *convs, pool=None):
    out = x
    if pool == "avg":
        out = mx.sym.Pooling(out, kernel=(3, 3), stride=(1, 1),
                             pad=(1, 1), pool_type="avg")
    elif pool == "max":
        out = mx.sym.Pooling(out, kernel=(3, 3), stride=(2, 2),
                             pool_type="max")
    for i, (nf, k, s, p) in enumerate(convs):
        out = _conv(out, nf, k, s, p, name=f"{name}_{i}")
    return out


def _block_a(x, pool_features, name):
    return mx.sym.concat(
        _branch(x, name + "_b0", (64, (1, 1), (1, 1), (0, 0))),
        _branch(x, name + "_b1", (48, (1, 1), (1, 1), (0, 0)),
                (64, (5, 5), (1, 1), (2, 2))),
        _branch(x, name + "_b2", (64, (1, 1), (1, 1), (0, 0)),
                (96, (3, 3), (1, 1), (1, 1)),
                (96, (3, 3), (1, 1), (1, 1))),
        _branch(x, name + "_b3", (pool_features, (1, 1), (1, 1), (0, 0)),
                pool="avg"), dim=1)


def _block_b(x, name):
    return mx.sym.concat(
        _branch(x, name + "_b0", (384, (3, 3), (2, 2), (0, 0))),
        _branch(x, name + "_b1", (64, (1, 1), (1, 1), (0, 0)),
                (96, (3, 3), (1, 1), (1, 1)),
                (96, (3, 3), (2, 2), (0, 0))),
        _branch(x, name + "_b2", pool="max"), dim=1)


def _block_c(x, c7, name):
    return mx.sym.concat(
        _branch(x, name + "_b0", (192, (1, 1), (1, 1), (0, 0))),
        _branch(x, name + "_b1", (c7, (1, 1), (1, 1), (0, 0)),
                (c7, (1, 7), (1, 1), (0, 3)),
                (192, (7, 1), (1, 1), (3, 0))),
        _branch(x, name + "_b2", (c7, (1, 1), (1, 1), (0, 0)),
                (c7, (7, 1), (1, 1), (3, 0)),
                (c7, (1, 7), (1, 1), (0, 3)),
                (c7, (7, 1), (1, 1), (3, 0)),
                (192, (1, 7), (1, 1), (0, 3))),
        _branch(x, name + "_b3", (192, (1, 1), (1, 1), (0, 0)),
                pool="avg"), dim=1)


def _block_d(x, name):
    return mx.sym.concat(
        _branch(x, name + "_b0", (192, (1, 1), (1, 1), (0, 0)),
                (320, (3, 3), (2, 2), (0, 0))),
        _branch(x, name + "_b1", (192, (1, 1), (1, 1), (0, 0)),
                (192, (1, 7), (1, 1), (0, 3)),
                (192, (7, 1), (1, 1), (3, 0)),
                (192, (3, 3), (2, 2), (0, 0))),
        _branch(x, name + "_b2", pool="max"), dim=1)


def _block_e(x, name):
    def split(y, nf, name):
        a = _conv(y, nf, (1, 3), (1, 1), (0, 1), name=name + "_a")
        b = _conv(y, nf, (3, 1), (1, 1), (1, 0), name=name + "_b")
        return mx.sym.concat(a, b, dim=1)

    b1 = _conv(x, 384, (1, 1), name=name + "_b1")
    b2 = _conv(x, 448, (1, 1), name=name + "_b2_0")
    b2 = _conv(b2, 384, (3, 3), (1, 1), (1, 1), name=name + "_b2_1")
    b3 = mx.sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        pool_type="avg")
    b3 = _conv(b3, 192, (1, 1), name=name + "_b3")
    return mx.sym.concat(
        _branch(x, name + "_b0", (320, (1, 1), (1, 1), (0, 0))),
        split(b1, 384, name + "_s1"), split(b2, 384, name + "_s2"),
        b3, dim=1)


def get_symbol(num_classes=1000, **kwargs):
    x = mx.sym.Variable("data")
    x = _conv(x, 32, (3, 3), (2, 2), name="stem0")
    x = _conv(x, 32, (3, 3), name="stem1")
    x = _conv(x, 64, (3, 3), pad=(1, 1), name="stem2")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 80, (1, 1), name="stem3")
    x = _conv(x, 192, (3, 3), name="stem4")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _block_a(x, 32, "mixed0")
    x = _block_a(x, 64, "mixed1")
    x = _block_a(x, 64, "mixed2")
    x = _block_b(x, "mixed3")
    x = _block_c(x, 128, "mixed4")
    x = _block_c(x, 160, "mixed5")
    x = _block_c(x, 160, "mixed6")
    x = _block_c(x, 192, "mixed7")
    x = _block_d(x, "mixed8")
    x = _block_e(x, "mixed9")
    x = _block_e(x, "mixed10")
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(8, 8))
    x = mx.sym.Flatten(x)
    x = mx.sym.Dropout(x, p=0.5)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")
