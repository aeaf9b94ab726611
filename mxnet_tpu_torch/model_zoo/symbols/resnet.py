"""ResNet symbol (He et al., "Identity Mappings in Deep Residual
Networks"): a copy of ``examples/image_classification/symbols/resnet.py``
written against the port's ``sym``, so the port builds the same graph
(and the same JSON) without importing the JAX package.

Pre-activation (v2) units. The ImageNet stem is the 7x7/s2 convolution
(``stem="std"``) or its exact space-to-depth rewrite (``stem="s2d"``,
``ops/nn.py`` ``conv_s2d_stem``: the same ``conv0_weight``, the same
output).
"""
from ... import symbol as sym
from ...base import MXNetError


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    """A pre-activation residual unit."""
    bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                           momentum=bn_mom, name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu",
                             name=name + "_relu1")
    if bottle_neck:
        conv1 = sym.Convolution(data=act1, num_filter=num_filter // 4,
                                   kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                   no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                               momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu",
                                 name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter // 4,
                                   kernel=(3, 3), stride=stride, pad=(1, 1),
                                   no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                               momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu",
                                 name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter,
                                   kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                   no_bias=True, name=name + "_conv3")
        body = conv3
    else:
        conv1 = sym.Convolution(data=act1, num_filter=num_filter,
                                   kernel=(3, 3), stride=stride, pad=(1, 1),
                                   no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                               momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu",
                                 name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter,
                                   kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                   no_bias=True, name=name + "_conv2")
        body = conv2
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                      kernel=(1, 1), stride=stride,
                                      no_bias=True, name=name + "_sc")
    return body + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, stem="std"):
    data = sym.Variable("data")
    nchannel, height, _ = image_shape
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                            momentum=bn_mom, name="bn_data")
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                                  kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                  no_bias=True, name="conv0")
    else:  # imagenet stem
        if stem == "s2d":
            w0 = sym.Variable("conv0_weight",
                              shape=(filter_list[0], nchannel, 7, 7))
            body = sym.conv_s2d_stem(data=data, weight=w0, name="conv0")
        elif stem == "std":
            body = sym.Convolution(data=data, num_filter=filter_list[0],
                                   kernel=(7, 7), stride=(2, 2),
                                   pad=(3, 3), no_bias=True, name="conv0")
        else:
            raise MXNetError(f"unknown stem {stem!r} (std or s2d)")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                                momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                              pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 and height > 32 else (2, 2) if i > 0 \
            else (1, 1)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                           momentum=bn_mom, name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes,
                                name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_symbol(num_classes, num_layers, image_shape, **kwargs):
    """(reference: symbols/resnet.py get_symbol — unit counts per depth)"""
    image_shape = [int(x) for x in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    _, height, _ = image_shape
    if height <= 32:  # cifar
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError(f"no experiments done on num_layers "
                             f"{num_layers}")
        units = per_unit * num_stages
    else:  # imagenet
        num_stages = 4
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        units_map = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                     200: [3, 24, 36, 3]}
        if num_layers not in units_map:
            raise ValueError(f"no experiments done on num_layers "
                             f"{num_layers}")
        units = units_map[num_layers]
    return resnet(units=units, num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=image_shape, bottle_neck=bottle_neck,
                  stem=kwargs.get("stem", "std"))
