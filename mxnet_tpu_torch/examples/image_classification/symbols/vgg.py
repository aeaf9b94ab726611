"""VGG 11/13/16/19 (Simonyan & Zisserman 2014).

The port's copy of ``examples/image_classification/symbols/vgg.py``,
written against ``mxnet_tpu_torch``: the same graph, names and JSON.
"""
import mxnet_tpu_torch as mx

_SPEC = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
         16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
_FILTERS = (64, 128, 256, 512, 512)


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    assert num_layers in _SPEC, f"vgg-{num_layers} not defined"
    x = mx.sym.Variable("data")
    for si, (reps, nf) in enumerate(zip(_SPEC[num_layers], _FILTERS)):
        for ri in range(reps):
            x = mx.sym.Convolution(x, num_filter=nf, kernel=(3, 3),
                                   pad=(1, 1),
                                   name=f"conv{si + 1}_{ri + 1}")
            if batch_norm:
                x = mx.sym.BatchNorm(x, name=f"bn{si + 1}_{ri + 1}")
            x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    x = mx.sym.Flatten(x)
    for i, fc in enumerate((4096, 4096)):
        x = mx.sym.FullyConnected(x, num_hidden=fc, name=f"fc{i + 6}")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Dropout(x, p=0.5)
    x = mx.sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return mx.sym.SoftmaxOutput(x, name="softmax")
