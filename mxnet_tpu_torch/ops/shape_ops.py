"""Shape, indexing and joining ops (counterpart of
``mxnet_tpu/ops/shape_ops.py``): those the symbol paths, NDArray's
methods and the Gluon layers and losses call."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dtype import resolve_dtype
from .registry import register_op


@register_op("Reshape", aliases=["reshape"])
def reshape(data, shape=None, reverse=False, **kw):
    """MXNet reshape with its special codes: 0 copies a dim, -1 infers
    one, -2 copies the rest, -3 merges two dims, -4 splits one
    (reference: matrix_op.cc ReshapeShape)."""
    if shape is None:
        return data
    shape = tuple(shape)
    src = list(data.shape)
    if reverse:
        src, shape = src[::-1], tuple(reversed(shape))
    out, src_i, i = [], 0, 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            a, b = shape[i + 1], shape[i + 2]
            dim = src[src_i]
            a = dim // b if a == -1 else a
            b = dim // a if b == -1 else b
            out.extend([a, b])
            src_i += 1
            i += 2
        else:
            out.append(s)
            src_i += 1
        i += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


@register_op("Flatten", aliases=["flatten"])
def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)


@register_op("transpose")
def transpose(data, axes=None, **kw):
    axes = tuple(axes) if axes else tuple(reversed(range(data.dim())))
    return data.permute(axes)


@register_op("expand_dims")
def expand_dims(data, axis=0, **kw):
    return data.unsqueeze(axis)


@register_op("squeeze")
def squeeze(data, axis=None, **kw):
    if axis is None:
        return data.squeeze()
    return data.squeeze(tuple(axis) if isinstance(axis, (tuple, list))
                        else axis)


@register_op("SwapAxis", aliases=["swapaxes"])
def swapaxes(data, dim1=0, dim2=0, **kw):
    return data.transpose(dim1, dim2)


@register_op("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None, **kw):
    axis = axis % data.dim()
    sl = [slice(None)] * data.dim()
    sl[axis] = slice(begin, end)
    return data[tuple(sl)]


@register_op("clip")
def clip(data, a_min=None, a_max=None, **kw):
    return torch.clamp(data, a_min, a_max)


@register_op("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32", **kw):
    idx = indices.to(torch.int64)
    oh = ((idx.unsqueeze(-1) == torch.arange(depth, device=idx.device))
          & (idx.unsqueeze(-1) >= 0)).to(torch.float32)
    return (oh * on_value + (1.0 - oh) * off_value).to(resolve_dtype(dtype))


@register_op("where")
def where(condition, x, y, **kw):
    cond = condition if condition.dtype == torch.bool else condition != 0
    return torch.where(cond, x, y)


@register_op("zeros_like")
def zeros_like(data, **kw):
    return torch.zeros_like(data)


@register_op("ones_like")
def ones_like(data, **kw):
    return torch.ones_like(data)


@register_op("Concat", aliases=["concat"])
def concat(*args, dim=1, num_args=None, **kw):
    return torch.cat(args, dim=dim)


@register_op("stack")
def stack(*args, axis=0, num_args=None, **kw):
    return torch.stack(args, dim=axis)


@register_op("SliceChannel", aliases=["split"], num_outputs=-1)
def split(data, num_outputs=2, axis=1, squeeze_axis=False, **kw):
    """``num_outputs`` equal slices along ``axis`` (a tuple, as the
    reference's multi-output op), the axis squeezed with
    ``squeeze_axis``."""
    outs = torch.chunk(data, int(num_outputs), dim=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs)


@register_op("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """Contracts lhs's last axis with rhs's first (reference: dot.cc;
    not numpy's matmul for ndim > 2)."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    return torch.tensordot(a, b, dims=1)


@register_op("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, **kw):
    """Rows of ``weight`` at the ids ``data`` (float ids truncate toward
    zero), with the JAX package's ``jnp.take`` semantics: ids in
    ``[-n, -1]`` wrap, and an id ``>= n`` or ``< -n`` gives a row of NaN
    (``take``'s ``fill`` mode). An out-of-range gather would be a
    device-side assert on the card, which ends the CUDA context, so the
    ids are wrapped, the rest clamped into range for the gather, and the
    invalid rows replaced by NaN: their gradient is zero. The gather's
    backward is ``F.embedding``'s, which sums repeated ids in a fixed
    order (the step's replays stay bit-identical); ``sparse_grad`` is
    advisory, as in the JAX package."""
    n = weight.shape[0]
    idx = data.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = F.embedding(torch.where(valid, idx, torch.zeros_like(idx)),
                       weight)
    return torch.where(valid.unsqueeze(-1), rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


@register_op("_contrib_SparseEmbedding", aliases=["SparseEmbedding"])
def sparse_embedding(data, weight, input_dim=None, output_dim=None,
                     dtype="float32", sparse_grad=True, **kw):
    """``Embedding``'s forward whose weight gradient is built from
    deduplicated rows (``sparse/embedding.py``); the fused Module step
    routes these nodes row-sparse and never builds the dense table
    gradient."""
    from ..sparse.embedding import sparse_embedding as _fn
    return _fn(data, weight)


@register_op("_contrib_sparse_segment_sum")
def sparse_segment_sum(data, segment_ids, num_segments=None, **kw):
    """Sums ``data`` rows into ``num_segments`` buckets (the dedup's
    building block, ``sparse/rowsparse.segment_rows``)."""
    from ..sparse.rowsparse import segment_rows
    n = int(num_segments) if num_segments is not None \
        else int(data.shape[0])
    return segment_rows(data, segment_ids, n)
