"""Linear-algebra ops (counterpart of ``mxnet_tpu/ops/linalg.py``;
reference: src/operator/tensor/la_op.cc, contrib/krprod.cc).

The products are ``torch.matmul``, as the JAX package leaves them to
XLA; the factorizations call torch.linalg, as no Pallas kernel stands
behind them there either. Each form used checks no error on the host
(``cholesky_ex(check_errors=False)``, ``solve_triangular``, ``qr``), so
it can run inside a captured program. ``torch.linalg.eigh`` checks its
result on the host, and torch has no form that does not: ``linalg_syevd``
raises inside a capture, naming itself (ROADMAP lists it).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register_op


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


@register_op("linalg_gemm", aliases=["_linalg_gemm"])
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2, **kw):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register_op("linalg_gemm2", aliases=["_linalg_gemm2"])
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2, **kw):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register_op("linalg_potrf", aliases=["_linalg_potrf"])
def linalg_potrf(A, **kw):
    """The lower Cholesky factor; a matrix that is not positive definite
    gives a partial factor, not an error (no host check)."""
    return torch.linalg.cholesky_ex(A, check_errors=False).L


@register_op("linalg_potri", aliases=["_linalg_potri"])
def linalg_potri(A, **kw):
    """``(L Lᵀ)⁻¹`` from the Cholesky factor ``L``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register_op("linalg_trsm", aliases=["_linalg_trsm"])
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kw):
    """Solves ``op(A) X = alpha B`` (``rightside``: ``X op(A) = alpha
    B``) for triangular ``A``."""
    upper = not lower
    op_upper = (not upper) if transpose else upper
    return torch.linalg.solve_triangular(_t(A, transpose), alpha * B,
                                         upper=op_upper, left=not rightside)


@register_op("linalg_trmm", aliases=["_linalg_trmm"])
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kw):
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register_op("linalg_sumlogdiag", aliases=["_linalg_sumlogdiag"])
def linalg_sumlogdiag(A, **kw):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register_op("linalg_syrk", aliases=["_linalg_syrk"])
def linalg_syrk(A, transpose=False, alpha=1.0, **kw):
    a = _t(A, transpose)
    return alpha * torch.matmul(a, a.transpose(-1, -2))


@register_op("linalg_gelqf", aliases=["_linalg_gelqf"], num_outputs=2)
def linalg_gelqf(A, **kw):
    """LQ factorization ``A = L Q`` (Q with orthonormal rows), from the
    QR factorization of ``Aᵀ``, as the JAX package's."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register_op("linalg_syevd", aliases=["_linalg_syevd"], num_outputs=2)
def linalg_syevd(A, **kw):
    """(eigenvectors as rows, eigenvalues ascending) of a symmetric
    matrix. ``torch.linalg.eigh`` reads its error flags on the host, so
    this op cannot run inside a captured program: it raises there."""
    if A.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError("linalg_syevd cannot run inside a captured CUDA "
                         "program: torch.linalg.eigh checks its result on "
                         "the host (run the executor with captured=False)")
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w


@register_op("khatri_rao")
def khatri_rao(*args, **kw):
    """Column-wise Khatri-Rao product of (m_i, k) matrices: (Π m_i, k)."""
    out = args[0]
    for b in args[1:]:
        out = torch.einsum("ik,jk->ijk", out, b).reshape(-1, out.shape[1])
    return out
