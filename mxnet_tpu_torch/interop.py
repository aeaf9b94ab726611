"""Carrying weights between the JAX package and the port.

- ``params_from_jax`` turns the JAX package's parameter dicts (numpy
  arrays, or anything with ``asnumpy()`` or ``__array__``) into the
  port's tensor dicts under the same names.
- ``init_params`` makes a seeded numpy initialisation of a symbol's
  parameters that both packages can be fed from.
- ``gluon_params_from_jax`` carries a JAX Gluon net's parameters onto
  the port's net by name (the RNN layers' ``l0_i2h_weight``..., the
  cells' and a modifier cell's base cell's too).
- A ``FusedRNNCell``'s flat ``*_parameters`` vector is one array in the
  cuDNN layout in both packages: ``params_from_jax`` carries it as it
  carries any argument.
- ``decode_params_from_jax`` checks a decode LM's parameter dict against
  its ``TransformerLMSpec`` and stages it for ``DecodePredictor``.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, torch_dtype

__all__ = ["params_from_jax", "init_params", "gluon_params_from_jax",
           "decode_params_from_jax"]


def _to_numpy(name, v):
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    a = np.asarray(v)
    if a.dtype.kind not in "fiu":
        raise MXNetError(f"parameter '{name}' is not numeric ({a.dtype})")
    return a


def params_from_jax(arg_params, aux_params, device, dtype=None,
                    shapes=None):
    """``(arg_params, aux_params)`` as dicts of tensors on ``device``,
    under the same names. Float arrays are cast to ``dtype`` when given.
    ``shapes`` (optional {name: shape}, e.g. from ``infer_shape``) is
    checked against every array it names."""
    device = torch.device(device)
    dt = torch_dtype(dtype)

    def conv(params):
        out = {}
        for name, v in (params or {}).items():
            a = _to_numpy(name, v)
            if shapes is not None and name in shapes \
                    and tuple(a.shape) != tuple(shapes[name]):
                raise MXNetError(f"parameter '{name}' has shape {a.shape}, "
                                 f"expected {tuple(shapes[name])}")
            t = torch.tensor(a)
            if dt is not None and t.is_floating_point():
                t = t.to(dt)
            out[name] = t.to(device)
        return out

    return conv(arg_params), conv(aux_params)


def init_params(symbol, data_shapes, seed):
    """Seeded float32 numpy params for ``symbol``: ``(arg_params,
    aux_params)``. ``data_shapes`` maps each data input to its full
    shape (batch included); inputs whose name ends in ``label`` get no
    value. Weights are He-normal over their fan-in, biases and BN shifts
    small normal, BN scales near 1, moving means small normal and moving
    variances uniform in [0.5, 1.5] (always positive)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**{
        n: tuple(s) for n, s in data_shapes.items()})
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in data_shapes or name.endswith("label"):
            continue
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) * np.sqrt(1.0 / fan_in)
        elif name.endswith("gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # bias, beta
            v = 0.1 * rng.standard_normal(shape)
        args[name] = v.astype(np.float32)
    aux = {}
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        if name.endswith("var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        aux[name] = v.astype(np.float32)
    return args, aux


def gluon_params_from_jax(params, net, device):
    """Set every parameter of the port's Gluon ``net`` from ``params``
    ({name: array}, the JAX Gluon net's ``collect_params()`` values as
    numpy, or anything with ``asnumpy()``), by name. The names must
    match exactly; a shape the port's net already knows must match, and
    an unknown one (deferred init) is taken from the array. A parameter
    not initialized yet is created on ``device``; an initialized one is
    overwritten where it lies."""
    from .context import as_context
    from .ndarray.ndarray import NDArray
    ctx = as_context(device)
    ours = net.collect_params()
    missing = sorted(set(ours.keys()) - set(params))
    extra = sorted(set(params) - set(ours.keys()))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    for name, p in ours.items():
        a = _to_numpy(name, params[name])
        if p.shape_is_known() and tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"parameter '{name}' has shape {a.shape}, "
                             f"expected {tuple(p.shape)}")
        if p._data is not None:
            p.set_data(NDArray(torch.tensor(a)))
            continue
        p._infer_shape(a.shape)
        init, _, default_init, _ = p._deferred_init or (None, None, None,
                                                        None)
        p._deferred_init = (init, [ctx], default_init,
                            NDArray(torch.tensor(a)))
        p._finish_deferred_init()


def decode_params_from_jax(params, spec, device):
    """The JAX package's decode-LM parameters (``{name: numpy}``, as
    ``mxnet_tpu.serving.decode.init_params`` or ``Module.get_params()``
    give them) as float32 tensors on ``device``, checked name by name
    against ``spec.param_shapes()`` (a port ``TransformerLMSpec``); the
    result feeds ``DecodePredictor`` directly."""
    shapes = spec.param_shapes()
    missing = [n for n in shapes if n not in params]
    extra = [n for n in params if n not in shapes]
    if missing or extra:
        raise MXNetError(f"decode params do not fit the spec: missing "
                         f"{missing}, unexpected {extra}")
    args, _ = params_from_jax({n: params[n] for n in shapes}, None, device,
                              dtype="float32", shapes=shapes)
    return args
