"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): ResNet v1, v1b and
v2. The other models are not ported yet."""
from .resnet import *  # noqa: F401,F403

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1,  # noqa: F405
    "resnet50_v1b": resnet50_v1b, "resnet101_v1b": resnet101_v1b,  # noqa: F405
    "resnet152_v1b": resnet152_v1b,  # noqa: F405
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,  # noqa: F405
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,  # noqa: F405
    "resnet152_v2": resnet152_v2,  # noqa: F405
}


def get_model(name, **kwargs):
    """A model by name (reference: vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"Model {name} is not supported. Available "
                         "options are\n\t" + "\n\t".join(sorted(_MODELS)))
    return _MODELS[name](**kwargs)
