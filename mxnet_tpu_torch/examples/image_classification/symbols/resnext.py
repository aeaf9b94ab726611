"""ResNeXt (Xie et al. 2016): resnet bottlenecks with grouped 3x3 convs.

The port's copy of ``examples/image_classification/symbols/resnext.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx


def _bn(x, name):
    return mx.sym.BatchNorm(x, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name)


def residual_unit(data, num_filter, stride, dim_match, name,
                  num_group=32, bottle_neck=True):
    if bottle_neck:
        mid = num_filter // 2
        x = mx.sym.Convolution(data, num_filter=mid, kernel=(1, 1),
                               no_bias=True, name=name + "_conv1")
        x = _bn(x, name + "_bn1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Convolution(x, num_filter=mid, kernel=(3, 3),
                               stride=stride, pad=(1, 1),
                               num_group=num_group, no_bias=True,
                               name=name + "_conv2")
        x = _bn(x, name + "_bn2")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Convolution(x, num_filter=num_filter, kernel=(1, 1),
                               no_bias=True, name=name + "_conv3")
        x = _bn(x, name + "_bn3")
    else:
        x = mx.sym.Convolution(data, num_filter=num_filter, kernel=(3, 3),
                               stride=stride, pad=(1, 1), no_bias=True,
                               name=name + "_conv1")
        x = _bn(x, name + "_bn1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Convolution(x, num_filter=num_filter, kernel=(3, 3),
                               pad=(1, 1), no_bias=True,
                               name=name + "_conv2")
        x = _bn(x, name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        shortcut = mx.sym.Convolution(data, num_filter=num_filter,
                                      kernel=(1, 1), stride=stride,
                                      no_bias=True, name=name + "_sc")
        shortcut = _bn(shortcut, name + "_sc_bn")
    return mx.sym.Activation(x + shortcut, act_type="relu")


def get_symbol(num_classes=1000, num_layers=101, num_group=32, **kwargs):
    units = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
             152: (3, 8, 36, 3)}[num_layers]
    filters = (256, 512, 1024, 2048)
    x = mx.sym.Variable("data")
    x = mx.sym.Convolution(x, num_filter=64, kernel=(7, 7), stride=(2, 2),
                           pad=(3, 3), no_bias=True, name="conv0")
    x = _bn(x, "bn0")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for si, (n, nf) in enumerate(zip(units, filters)):
        for ui in range(n):
            stride = (1, 1) if si == 0 or ui > 0 else (2, 2)
            x = residual_unit(x, nf, stride, ui > 0,
                              f"stage{si + 1}_unit{ui + 1}",
                              num_group=num_group)
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7))
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(x, name="softmax")
