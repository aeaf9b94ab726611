"""MobileNet v1 (Howard et al. 2017): depthwise-separable convolutions.

The port's copy of ``examples/image_classification/symbols/mobilenet.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx

# (stride, out_channels) for each depthwise-separable block after the stem
_BLOCKS = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
           (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024),
           (1, 1024)]


def _conv_bn(x, nf, kernel, stride, pad, name, num_group=1):
    x = mx.sym.Convolution(x, num_filter=nf, kernel=kernel, stride=stride,
                           pad=pad, num_group=num_group, no_bias=True,
                           name=f"{name}_conv")
    x = mx.sym.BatchNorm(x, fix_gamma=False, name=f"{name}_bn")
    return mx.sym.Activation(x, act_type="relu", name=f"{name}_relu")


def get_symbol(num_classes=1000, multiplier=1.0, **kwargs):
    def ch(c):
        return max(8, int(c * multiplier))

    x = mx.sym.Variable("data")
    x = _conv_bn(x, ch(32), (3, 3), (2, 2), (1, 1), "conv1")
    cin = ch(32)
    for i, (stride, cout) in enumerate(_BLOCKS):
        x = _conv_bn(x, cin, (3, 3), (stride, stride), (1, 1),
                     f"dw{i + 1}", num_group=cin)      # depthwise
        x = _conv_bn(x, ch(cout), (1, 1), (1, 1), (0, 0),
                     f"pw{i + 1}")                     # pointwise
        cin = ch(cout)
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7))
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")
