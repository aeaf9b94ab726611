"""The JAX package's op-surface completion (counterpart of
``mxnet_tpu/ops/surface.py``), the parts the port carries: tensor
utilities (reshape_like, round, hypot, the slice and scatter
assignments), the KL sparsity regularizer, multi-precision SGD, the
contrib ``quadratic`` and the box ops ``box_iou`` and
``bipartite_matching`` (greedy matching: M1 on CUDA, ``ops/nms.py``),
the cuDNN-era ``CuDNNBatchNorm`` name and the per-element samplers. The
image, quantization and eager sparse-storage ops of that module are not
ported (ROADMAP A5 lists them).
"""
from __future__ import annotations

import torch

from . import elemwise as _elemwise
from .registry import register_op, alias
from .nms import bipartite_match
from .random_ops import (gen_of, uniform_, normal_, exponential_,
                         standard_gamma, poisson, gamma_poisson)
from .shape_ops import _nd_index, _scatter_into
from ..dtype import resolve_dtype


class _KLSparseReg(torch.autograd.Function):
    """The identity whose gradient adds the KL sparsity penalty's
    ``penalty * (-ρ/ρ̂ + (1-ρ)/(1-ρ̂)) / n``, ρ̂ the batch's mean
    activation per unit clipped to [1e-6, 1 - 1e-6] (the JAX package's
    custom_vjp: the current batch's mean, where the reference smooths it
    in an aux state)."""

    @staticmethod
    def forward(ctx, x, target, penalty):
        rho = torch.clamp(torch.mean(x, dim=0), 1e-6, 1 - 1e-6)
        ctx.save_for_backward(rho)
        ctx.target, ctx.penalty, ctx.n = target, penalty, x.shape[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rho, = ctx.saved_tensors
        t = ctx.target
        kl = ctx.penalty * (-t / rho + (1 - t) / (1 - rho))
        return g + kl.expand(g.shape) / ctx.n, None, None


@register_op("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9, **kw):
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


@register_op("reshape_like")
def reshape_like(lhs, rhs, **kw):
    return lhs.reshape(rhs.shape)


@register_op("round")
def round_(data, **kw):
    """Half away from zero (mshadow_op::round), not ``torch.round``'s
    half to even."""
    return torch.sign(data) * torch.floor(torch.abs(data) + 0.5)


@register_op("_hypot", aliases=["hypot"])
def hypot(lhs, rhs, **kw):
    return _elemwise.hypot(lhs, rhs)


@register_op("_hypot_scalar", aliases=["hypot_scalar"])
def hypot_scalar(data, scalar=0.0, **kw):
    return _elemwise.hypot(data, torch.full((), scalar, dtype=data.dtype,
                                        device=data.device))


@register_op("_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs, **kw):
    return lhs


def _slice_index(shape, begin, end, step, device):
    """Broadcastable index tensors of ``data[b0:e0:s0, ...]`` (every
    axis past ``begin`` whole); any step, negative ones too."""
    step = step or [None] * len(begin)
    idx = []
    for i, n in enumerate(shape):
        if i < len(begin):
            e = end[i] if i < len(end) else None
            s = step[i] if i < len(step) else None
            r = range(*slice(begin[i], e, s).indices(n))
            ix = torch.arange(r.start, r.stop, r.step, device=device) \
                if len(r) else torch.zeros(0, dtype=torch.int64,
                                           device=device)
        else:
            ix = torch.arange(n, device=device)
        idx.append(ix.reshape((1,) * i + (-1,) + (1,) * (len(shape) - i - 1)))
    return tuple(idx)


@register_op("_slice_assign", aliases=["_crop_assign"])
def slice_assign(lhs, rhs, begin=(), end=(), step=(), **kw):
    """``lhs`` with ``rhs`` written over ``lhs[begin:end:step]``."""
    idx = _slice_index(lhs.shape, begin, end, step, lhs.device)
    return lhs.index_put(idx, rhs.to(lhs.dtype))


@register_op("_slice_assign_scalar", aliases=["_crop_assign_scalar"])
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=(), **kw):
    idx = _slice_index(data.shape, begin, end, step, data.device)
    return data.index_put(idx, torch.full((), scalar, dtype=data.dtype,
                                          device=data.device))


# on dense storage the _scatter_ family is the plain op (the row-sparse
# form touches only stored rows)
@register_op("_scatter_plus_scalar")
def scatter_plus_scalar(data, scalar=0.0, **kw):
    return data + scalar


@register_op("_scatter_minus_scalar")
def scatter_minus_scalar(data, scalar=0.0, **kw):
    return data - scalar


@register_op("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs, **kw):
    return lhs / rhs


@register_op("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices, shape=None, **kw):
    """``lhs`` with ``rhs`` set at ``indices`` (scatter_nd's index
    semantics: negative entries wrap once, out-of-range updates are
    dropped)."""
    rows, valid = _nd_index(indices, lhs.shape)
    return _scatter_into(lhs, rows, valid, rhs)


@register_op("_contrib_quadratic", aliases=["quadratic"])
def quadratic(data, a=0.0, b=0.0, c=0.0, **kw):
    return a * torch.square(data) + b * data + c


@register_op("_contrib_box_iou", aliases=["box_iou"])
def box_iou(lhs, rhs, format="corner", **kw):
    """Pairwise IoU: lhs (..., N, 4), rhs (..., M, 4) -> (..., N, M), in
    corner or center format; the union floored at 1e-12 (not the
    MultiBox ops' IoU, which is 0 where the union is <= 0)."""
    def corners(b):
        if format == "center":
            x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
            return x - w / 2, y - h / 2, x + w / 2, y + h / 2
        return b[..., 0], b[..., 1], b[..., 2], b[..., 3]

    lx1, ly1, lx2, ly2 = (t[..., :, None] for t in corners(lhs))
    rx1, ry1, rx2, ry2 = (t[..., None, :] for t in corners(rhs))
    iw = torch.clamp_min(torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1),
                         0.0)
    inter = iw * ih
    area_l = torch.clamp_min((lx2 - lx1) * (ly2 - ly1), 0.0)
    area_r = torch.clamp_min((rx2 - rx1) * (ry2 - ry1), 0.0)
    return inter / torch.clamp_min(area_l + area_r - inter, 1e-12)


@register_op("_contrib_bipartite_matching", aliases=["bipartite_matching"],
             no_grad=True, num_outputs=2)
def bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1, **kw):
    """Greedy bipartite matching on score matrices data (..., N, M):
    entries visited by score (ascending with ``is_ascend``, else
    descending with the higher flat index first among ties), the first
    ``topk * max(N, M)`` of them when ``topk`` > 0; an entry matches when
    its row and column are free and its score is past ``threshold``.
    Returns (row_match (..., N), col_match (..., M)) float32, -1 where
    unmatched."""
    n, m = data.shape[-2], data.shape[-1]
    flat = data.reshape(-1, n * m).contiguous()
    order = torch.sort(flat, dim=-1, stable=True).indices
    if not is_ascend:
        order = order.flip(-1)
    k = n * m if topk is None or int(topk) <= 0 \
        else min(int(topk) * max(n, m), n * m)
    row, col = bipartite_match(flat, order.contiguous(), n, m, k,
                               float(threshold), bool(is_ascend))
    return row.reshape(data.shape[:-2] + (n,)), \
        col.reshape(data.shape[:-2] + (m,))


def _mp_grad(grad, rescale_grad, clip_gradient):
    g = grad.to(torch.float32) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register_op("mp_sgd_update", no_grad=True, num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False, **kw):
    """SGD on the fp32 master ``weight32`` of a bf16 / fp16 ``weight``:
    (new weight in its dtype, new master) (reference: optimizer_op.cc
    MP_SGD_Update)."""
    g = _mp_grad(grad, rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


@register_op("mp_sgd_mom_update", no_grad=True, num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False, **kw):
    """(new weight, new momentum, new master)."""
    g = _mp_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


# ---------------------------------------------------------------------------
# per-element sampling (reference: src/operator/random/sample_op.cc): one
# draw per parameter element, or ``shape`` draws each on new trailing axes
# ---------------------------------------------------------------------------
def _sample_shape(param, shape):
    if shape is None:
        shape = ()
    elif isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    return tuple(param.shape) + shape, shape


def _expand(param, sample_shape):
    return param.reshape(tuple(param.shape) + (1,) * len(sample_shape)) \
        .to(torch.float32)


@register_op("_sample_uniform", aliases=["sample_uniform"], no_grad=True)
def sample_uniform(low, high, shape=None, dtype="float32", generator=None,
                   **kw):
    out_shape, ss = _sample_shape(low, shape)
    u = uniform_(out_shape, low.device, gen_of(low.device, generator))
    lo = _expand(low, ss)
    return (lo + u * (_expand(high, ss) - lo)).to(resolve_dtype(dtype))


@register_op("_sample_normal", aliases=["sample_normal"], no_grad=True)
def sample_normal(mu, sigma, shape=None, dtype="float32", generator=None,
                  **kw):
    out_shape, ss = _sample_shape(mu, shape)
    z = normal_(out_shape, mu.device, gen_of(mu.device, generator))
    return (_expand(mu, ss) + z * _expand(sigma, ss)) \
        .to(resolve_dtype(dtype))


@register_op("_sample_gamma", aliases=["sample_gamma"], no_grad=True)
def sample_gamma(alpha, beta, shape=None, dtype="float32", generator=None,
                 **kw):
    out_shape, ss = _sample_shape(alpha, shape)
    g = standard_gamma(_expand(alpha, ss).expand(out_shape),
                       gen_of(alpha.device, generator))
    return (g * _expand(beta, ss)).to(resolve_dtype(dtype))


@register_op("_sample_exponential", aliases=["sample_exponential"],
             no_grad=True)
def sample_exponential(lam, shape=None, dtype="float32", generator=None,
                       **kw):
    out_shape, ss = _sample_shape(lam, shape)
    e = exponential_(out_shape, lam.device, gen_of(lam.device, generator))
    return (e / _expand(lam, ss)).to(resolve_dtype(dtype))


@register_op("_sample_poisson", aliases=["sample_poisson"], no_grad=True)
def sample_poisson(lam, shape=None, dtype="float32", generator=None, **kw):
    out_shape, ss = _sample_shape(lam, shape)
    return poisson(_expand(lam, ss).expand(out_shape),
                   gen_of(lam.device, generator)).to(resolve_dtype(dtype))


@register_op("_sample_negative_binomial",
             aliases=["sample_negative_binomial"], no_grad=True)
def sample_negative_binomial(k, p, shape=None, dtype="float32",
                             generator=None, **kw):
    out_shape, ss = _sample_shape(k, shape)
    pp = _expand(p, ss)
    return gamma_poisson(_expand(k, ss).expand(out_shape), (1 - pp) / pp,
                         gen_of(k.device, generator)) \
        .to(resolve_dtype(dtype))


@register_op("_sample_generalized_negative_binomial",
             aliases=["sample_generalized_negative_binomial"], no_grad=True)
def sample_gen_negative_binomial(mu, alpha, shape=None, dtype="float32",
                                 generator=None, **kw):
    out_shape, ss = _sample_shape(mu, shape)
    aa = torch.clamp_min(_expand(alpha, ss), 1e-8)
    return gamma_poisson((1.0 / aa).expand(out_shape), aa * _expand(mu, ss),
                         gen_of(mu.device, generator)) \
        .to(resolve_dtype(dtype))


# cuDNN-era name of BatchNorm
alias("BatchNorm", "CuDNNBatchNorm")
