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
    """``jnp.clip``: a maximum with ``a_min``, then a minimum with
    ``a_max``, so a value at a bound takes half the cotangent (the tie
    rule of both), where ``torch.clamp`` passes all of it."""
    if not data.is_floating_point():
        return torch.clamp(data, a_min, a_max)
    out = data
    if a_min is not None:
        out = torch.maximum(out, torch.full((), float(a_min),
                                            dtype=data.dtype,
                                            device=data.device))
    if a_max is not None:
        out = torch.minimum(out, torch.full((), float(a_max),
                                            dtype=data.dtype,
                                            device=data.device))
    return out


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


@register_op("Pad", aliases=["pad"])
def pad(data, mode="constant", pad_width=(), constant_value=0.0, **kw):
    """Pad every axis by the (before, after) pairs of the flat
    ``pad_width`` (reference: src/operator/pad.cc), in ``constant``,
    ``edge`` or ``reflect`` mode, as the JAX op's ``jnp.pad``. ``edge``
    and ``reflect`` pad the 1 to 3 trailing axes of 3- to 5-D data (the
    leading pairs must be 0, as the reference requires)."""
    pw = [int(v) for v in pad_width]
    if len(pw) != 2 * data.dim():
        raise ValueError(f"Pad: pad_width needs 2 entries per axis of "
                         f"{tuple(data.shape)}, got {tuple(pw)}")
    if mode not in ("constant", "edge", "reflect"):
        raise ValueError(f"Pad: unknown mode {mode!r}")
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(data.dim())]
    if mode == "constant":
        flat = [v for p in reversed(pairs) for v in p]
        return F.pad(data, flat, mode="constant", value=constant_value)
    lead = max(data.dim() - 3, 2) if data.dim() >= 3 else data.dim()
    if data.dim() not in (3, 4, 5) or any(pairs[i] != (0, 0)
                                          for i in range(lead)):
        raise ValueError(f"Pad: {mode} mode pads the trailing 1-3 axes of "
                         f"3-5-D data; got {tuple(pw)} for "
                         f"{tuple(data.shape)}")
    flat = [v for p in reversed(pairs[lead:]) for v in p]
    return F.pad(data, flat, mode="replicate" if mode == "edge"
                 else "reflect")


# ---------------------------------------------------------------------------
# slicing, indexing, tiling and the sequence ops (the JAX package's
# ops/shape_ops.py:85-330). Index inputs arrive as floats and truncate
# toward zero. No index reaches a gather or scatter out of range: the
# JAX package's out-of-range results (clamped, wrapped, NaN-filled or
# dropped, per op) are rebuilt around in-range indices, since an
# out-of-range CUDA gather is a device assert (ROADMAP C-ref-3).
# ---------------------------------------------------------------------------
def _index(indices):
    return indices.to(torch.int64)


def _slice_one(data, axis, b, e, s):
    """``data`` sliced along ``axis`` by Python's ``slice(b, e, s)``; a
    negative step reverses, which torch's basic indexing does not
    take."""
    n = data.shape[axis]
    start, stop, step = slice(b, e, s).indices(n)
    if step > 0:
        sl = [slice(None)] * data.dim()
        sl[axis] = slice(start, stop, step)
        return data[tuple(sl)]
    count = len(range(start, stop, step))
    if count == 0:
        return data.narrow(axis, 0, 0)
    last = start + (count - 1) * step
    part = data.narrow(axis, last, start - last + 1).flip(axis)
    sl = [slice(None)] * data.dim()
    sl[axis] = slice(None, None, -step)
    return part[tuple(sl)]


@register_op("slice", aliases=["crop"])
def slice_op(data, begin=(), end=(), step=(), **kw):
    """``data[b0:e0:s0, b1:e1:s1, ...]`` for the leading axes (reference:
    matrix_op.cc Slice); entries may be None, steps negative."""
    step = step or (None,) * len(begin)
    out = data
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _slice_one(out, ax, b, e, s)
    return out


@register_op("slice_like")
def slice_like(data, shape_like, axes=(), **kw):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    sl = [slice(None)] * data.dim()
    for a in axes:
        sl[a % data.dim()] = slice(0, shape_like.shape[a % shape_like.dim()])
    return data[tuple(sl)]


def _nan_fill(rows, valid):
    """``rows`` where ``valid`` (broadcast over trailing dims), NaN
    elsewhere (``jnp.take``'s fill mode)."""
    v = valid.reshape(valid.shape + (1,) * (rows.dim() - valid.dim()))
    return torch.where(v, rows, torch.full((), float("nan"),
                                           dtype=rows.dtype,
                                           device=rows.device))


@register_op("take")
def take(a, indices, axis=0, mode="clip", **kw):
    """Slices of ``a`` along ``axis`` at ``indices`` (reference:
    indexing_op.cc take): ``clip`` clamps (a negative index takes the
    first slice), ``wrap`` takes the index modulo the size; any other
    mode has ``jnp.take``'s fill semantics: indices in [-n, -1] wrap,
    the rest give NaN."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = _index(indices)
    if mode == "clip":
        valid = None
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        valid = None
        idx = idx.remainder(n)
    else:
        idx = torch.where(idx < 0, idx + n, idx)
        valid = (idx >= 0) & (idx < n)
        idx = torch.where(valid, idx, torch.zeros_like(idx))
    out = torch.index_select(a, axis, idx.reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if valid is None:
        return out
    return _nan_fill(out, valid.reshape((1,) * axis + tuple(valid.shape)))


@register_op("batch_take")
def batch_take(a, indices, **kw):
    """``a[i, indices[i]]`` per row, with ``take_along_axis``'s fill
    semantics (indices in [-n, -1] wrap, the rest give NaN)."""
    n = a.shape[1]
    idx = _index(indices).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    lead = (-1, 1) + (1,) * (a.dim() - 2)
    out = torch.gather(a, 1, idx.reshape(lead).expand(
        (a.shape[0], 1) + tuple(a.shape[2:])))[:, 0]
    return _nan_fill(out, valid)


def _nd_index(indices, shape):
    """The (M, ...) index rows of gather_nd / scatter_nd as int64, each
    row's negative entries wrapped once; with a mask of the in-range
    positions."""
    idx = _index(indices)
    rows, valid = [], None
    for k in range(idx.shape[0]):
        r = idx[k]
        r = torch.where(r < 0, r + shape[k], r)
        ok = (r >= 0) & (r < shape[k])
        valid = ok if valid is None else valid & ok
        rows.append(r)
    return rows, valid


@register_op("gather_nd")
def gather_nd(data, indices, **kw):
    """``data[indices[0], indices[1], ...]``: negative entries wrap once,
    then every entry is clamped into range (JAX's gather); the gradient
    reaches only the rows that were in range (its transpose, a scatter,
    drops the others)."""
    rows, valid = _nd_index(indices, data.shape)
    rows = [r.clamp(0, data.shape[k] - 1) for k, r in enumerate(rows)]
    out = data[tuple(rows)]
    v = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return torch.where(v, out, out.detach())


def _scatter_into(base, rows, valid, values):
    """``base`` with ``values`` set at the index rows; updates at
    out-of-range rows are dropped (JAX's scatter). Every write lands in
    range: the dropped ones go to one spare slot past the end."""
    m = len(rows)
    lead = base.shape[:m]
    flat = base.reshape((-1,) + tuple(base.shape[m:]))
    lin = torch.zeros_like(rows[0])
    for k, r in enumerate(rows):
        lin = lin * lead[k] + r.clamp(0, lead[k] - 1)
    lin = torch.where(valid, lin, torch.full_like(lin, flat.shape[0]))
    spare = torch.zeros((1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                        device=flat.device)
    vals = values.reshape((-1,) + tuple(flat.shape[1:])).to(flat.dtype)
    out = torch.cat([flat, spare]).index_put((lin.reshape(-1),), vals)
    return out[:-1].reshape(base.shape)


@register_op("scatter_nd")
def scatter_nd(data, indices, shape=None, **kw):
    """Zeros of ``shape`` with ``data`` set at ``indices``; duplicate
    indices are undefined, as in MXNet and the JAX package."""
    shape = tuple(int(s) for s in shape)
    rows, valid = _nd_index(indices, shape)
    base = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return _scatter_into(base, rows, valid, data)


@register_op("tile")
def tile(data, reps=(), **kw):
    return torch.tile(data, tuple(int(r) for r in reps))


@register_op("repeat")
def repeat(data, repeats=1, axis=None, **kw):
    """Each element ``repeats`` times along ``axis`` (None: the
    flattened array), as ``jnp.repeat``."""
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register_op("reverse", aliases=["flip"])
def reverse(data, axis=(), **kw):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axis)


# the JAX package asks for int64, which JAX without x64 gives as int32:
# the port returns int32 as the JAX package does (ROADMAP C-ref-9)
@register_op("shape_array", no_grad=True)
def shape_array(data, **kw):
    out = torch.zeros(data.dim(), dtype=torch.int32, device=data.device)
    for i, d in enumerate(data.shape):
        out[i] = d
    return out


@register_op("size_array", no_grad=True)
def size_array(data, **kw):
    return torch.full((1,), data.numel(), dtype=torch.int32,
                      device=data.device)


@register_op("diag")
def diag(data, k=0, **kw):
    """The k-th diagonal of a matrix, the matrix of a vector's, or for
    more dims the diagonal of the first two axes moved last, as
    ``jnp.diag`` / ``jnp.diagonal``."""
    if data.dim() <= 2:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=0, dim2=1)


@register_op("depth_to_space")
def depth_to_space(data, block_size=1, **kw):
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(data, block_size=1, **kw):
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register_op("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register_op("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance", **kw):
    """``data / sqrt(sum(data²) + eps)`` over every axis but the first
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``) (reference: l2_normalization.cc)."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    else:
        ax = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                       keepdim=True) + eps)


@register_op("sequence_mask", aliases=["SequenceMask"])
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kw):
    """Steps at or past each sequence's length set to ``value``
    (reference: sequence_mask.cc); data is (T, N, ...) for axis 0, (N,
    T, ...) for axis 1."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    lens = sequence_length.to(torch.int32)
    if axis == 0:
        mask = pos[:, None] < lens[None, :]
    else:
        mask = pos[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register_op("sequence_last", aliases=["SequenceLast"])
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kw):
    """Each sequence's last valid step, with ``take_along_axis``'s fill
    semantics for a length out of [1, T] (0 wraps to the last step,
    the rest give NaN)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    moved = torch.movedim(data, axis, 0)
    t = moved.shape[0]
    last = _index(sequence_length) - 1
    last = torch.where(last < 0, last + t, last)
    valid = (last >= 0) & (last < t)
    last = torch.where(valid, last, torch.zeros_like(last))
    idx = last.reshape((1, -1) + (1,) * (moved.dim() - 2)) \
        .expand((1,) + tuple(moved.shape[1:]))
    return _nan_fill(torch.gather(moved, 0, idx).squeeze(0), valid)


@register_op("sequence_reverse", aliases=["SequenceReverse"])
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kw):
    """Each sequence's first ``length`` steps reversed, the padding left
    in place (data (T, N, ...))."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    t = data.shape[0]
    lens = sequence_length.to(torch.int64)
    pos = torch.arange(t, device=data.device)[:, None]
    rev = torch.where(pos < lens[None, :], lens[None, :] - 1 - pos, pos)
    rev = torch.where(rev < 0, rev + t, rev).clamp(0, t - 1)
    idx = rev.reshape(rev.shape + (1,) * (data.dim() - 2)) \
        .expand(data.shape)
    return torch.gather(data, 0, idx)
