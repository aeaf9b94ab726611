"""ResNet (He et al., "Identity Mappings in Deep Residual Networks"):
the port's ``model_zoo/symbols/resnet.py``, under the example's module
name. It builds the graph (and the JSON) of
``examples/image_classification/symbols/resnet.py``.
"""
from mxnet_tpu_torch.model_zoo.symbols.resnet import (  # noqa: F401
    get_symbol, residual_unit, resnet)
