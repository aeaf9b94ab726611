"""Graph functions for training (counterpart of ``build_graph_fns`` in
``mxnet_tpu/executor.py``).

``build_graph_fns(sym)`` gives the forward and the forward-plus-loss
functions the fused training step differentiates. The loss is each
implicit-loss head's loss (SoftmaxOutput: cross-entropy whose gradient
is p - y) over the head's input, so its gradient wrt the arguments is the
reference backward. The head inputs are taken from the same walk as the
outputs, never recomputed. The bound ``Executor``, its per-op paths and
explicit head gradients (``backward(out_grads)``) are not ported.
"""
from __future__ import annotations

import torch

from .ops import nn as _nn
from .ops.registry import parse_attr

__all__ = ["build_graph_fns", "collect_loss_specs", "total_implicit_loss"]

# output-layer ops whose backward is the gradient of an implicit loss
_IMPLICIT_LOSS = {
    "SoftmaxOutput": _nn.softmax_output_loss,
    "Softmax": _nn.softmax_output_loss,
}


def collect_loss_specs(sym):
    """(output_index, head node, parsed attrs) for every implicit-loss
    head."""
    specs = []
    for i, h in enumerate(sym._output_symbols()):
        node = h._node
        if node.op in _IMPLICIT_LOSS:
            attrs = {k: parse_attr(v) for k, v in node.attrs.items()
                     if not k.startswith("__")}
            specs.append((i, node, attrs))
    return specs


def total_implicit_loss(loss_specs, head_inputs, device):
    """Scalar fp32 training loss: the sum of each implicit head's loss
    over its input values."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for (_, node, attrs), ins in zip(loss_specs, head_inputs):
        total = total + _IMPLICIT_LOSS[node.op](*ins, **attrs).float()
    return total


def build_graph_fns(sym):
    """Pure forward / forward-with-implicit-loss functions of ``sym``:
    ``(fwd, fwd_loss, loss_specs)``.

        fwd(arg_vals, aux_vals, training) -> (outs, aux_updates)
        fwd_loss(arg_vals, aux_vals) -> (scalar, (outs, aux_updates))

    ``arg_vals``/``aux_vals`` follow ``sym.list_arguments()`` /
    ``list_auxiliary_states()``; ``fwd_loss`` walks in training mode."""
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    loss_specs = collect_loss_specs(sym)
    heads = [[(p, oi) for p, oi in node.inputs]
             for _, node, _ in loss_specs]
    flat_heads = [h for hs in heads for h in hs]

    def _amap(arg_vals, aux_vals):
        amap = dict(zip(arg_names, arg_vals))
        amap.update(zip(aux_names, aux_vals))
        return amap

    def fwd(arg_vals, aux_vals, training):
        outs, aux_updates, _ = sym.eval_arrays_ex(
            _amap(arg_vals, aux_vals), training=training)
        return tuple(outs), aux_updates

    def fwd_loss(arg_vals, aux_vals):
        outs, aux_updates, captured = sym.eval_arrays_ex(
            _amap(arg_vals, aux_vals), training=True, capture=flat_heads)
        head_inputs, k = [], 0
        for hs in heads:
            head_inputs.append(captured[k:k + len(hs)])
            k += len(hs)
        total = total_implicit_loss(loss_specs, head_inputs,
                                    outs[0].device if outs else None)
        return total, (tuple(outs), aux_updates)

    return fwd, fwd_loss, loss_specs
