"""Checkpoint helpers (counterpart of ``mxnet_tpu/model.py``; reference:
python/mxnet/model.py — save_checkpoint :413, load_checkpoint :455).

The files are the JAX package's: ``prefix-symbol.json`` (the graph) and
``prefix-NNNN.params`` (arrays keyed ``arg:name`` / ``aux:name``), so a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

# what a batch-end callback receives (the reference's typename)
BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``; the arrays are NDArrays on
    the CPU."""
    symbol = sym.load(f"{prefix}-symbol.json")
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
