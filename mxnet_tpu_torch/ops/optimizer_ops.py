"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``; reference: src/operator/optimizer_op.cc):
sgd_update, sgd_mom_update, nag_mom_update, adam_update, rmsprop_update,
rmspropalex_update, ftrl_update, signsgd_update, signum_update and
ftml_update, under the reference's names, so ``nd.adam_update(...)`` and
symbol graphs find them. Each returns new tensors (the eager optimizer
classes write them into their NDArrays); the arithmetic is the JAX ops',
in plain PyTorch (the reference leaves it to XLA, which fuses it).
"""
from __future__ import annotations

import torch

from .registry import register_op


def _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register_op("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False, **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@register_op("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=False,
                   **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom - lr * g
    return weight + mom_new, mom_new


@register_op("nag_mom_update", num_outputs=2)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom + g
    return weight - lr * (g + momentum * mom_new), mom_new


@register_op("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False, **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    w_new = weight - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return w_new, mean_new, var_new


@register_op("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    w_new = weight - lr * g / torch.sqrt(n_new + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w_new = torch.clamp(w_new, -clip_weights, clip_weights)
    return w_new, n_new


@register_op("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0, **kw):
    g = _apply_wd_rescale_clip(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_new = gamma1 * g_state + (1 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - torch.square(g_new) + epsilon)
    w_new = weight + delta_new
    if clip_weights is not None and clip_weights > 0:
        w_new = torch.clamp(w_new, -clip_weights, clip_weights)
    return w_new, n_new, g_new, delta_new


@register_op("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w_new = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(weight),
        (torch.sign(z_new) * lamda1 - z_new) /
        ((beta + torch.sqrt(n_new)) / lr + wd))
    return w_new, z_new, n_new


@register_op("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register_op("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.9, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **kw):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1 - momentum) * (g + wd * weight)
    w_new = (1 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w_new, mom_new


@register_op("ftml_update", num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                t=1, **kw):
    g = grad * rescale_grad + wd * weight
    if clip_grad is not None and clip_grad > 0:
        g = torch.clamp(g, -clip_grad, clip_grad)
    v_new = beta2 * v + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new
