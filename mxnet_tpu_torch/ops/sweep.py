"""Seeded cases for every op name the port took over in its op-set
slice: inputs, attributes, tolerance and the inputs each gradient is
taken for. The CPU tests feed each case through the JAX package's op and
the port's; ``chip_smoke.py`` feeds it through the port on the card and
on the CPU. Imports no JAX.

A case is ``Case(op, family, make, attrs, tol, grad, check)``:
``make(rs)`` builds the numpy inputs from a ``RandomState``; ``tol`` is
the forward tolerance (0.0: exact), the backward one ten times it;
``grad`` lists the input positions differentiated (empty: the op records
no gradient); ``check`` names a comparison other than element by element
(``syevd``: eigenvectors up to each row's sign). Cotangents are small
integers, so the gradient of a gather, a tile or a sort sums exactly in
any order.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["Case", "CASES", "SAMPLERS", "SAMPLER_PARAMS",
           "MULTINOMIAL_PROBS", "NEW_NAMES", "CONTRIB_NAMES", "BOX_OPS",
           "STAY_MISSING", "EXACT", "ARITH",
           "SPECIAL", "FAMILIES", "case_seed", "cotangent", "cases_of",
           "run_port", "sampler_dists", "bilinear_weight",
           "padded_sequence_symbol"]

EXACT, ARITH, SPECIAL = 0.0, 1e-5, 1e-4
FAMILIES = ("math", "index", "sort", "linalg", "random", "nn", "contrib")


class Case:
    __slots__ = ("op", "family", "make", "attrs", "tol", "grad", "check",
                 "tag")

    def __init__(self, op, family, make, attrs=None, tol=ARITH, grad=None,
                 check=None, tag=""):
        self.op = op
        self.family = family
        self.make = make
        self.attrs = dict(attrs or {})
        self.tol = tol
        self.grad = grad
        self.check = check
        self.tag = tag

    @property
    def id(self):
        return f"{self.op}{'-' + self.tag if self.tag else ''}"

    def inputs(self):
        return [np.asarray(a) for a in self.make(
            np.random.RandomState(case_seed(self.id)))]

    def no_cot(self):
        """Outputs given no cotangent: syevd's eigenvectors, whose signs
        are arbitrary (its gradient then comes through the eigenvalues
        alone, ``Vᵀ diag(ct) V``, which no sign changes)."""
        return (0,) if self.check == "syevd" else ()

    def grad_positions(self, inputs):
        if self.grad is not None:
            return list(self.grad)
        return [i for i, a in enumerate(inputs)
                if np.issubdtype(a.dtype, np.floating)]


def case_seed(case_id):
    return zlib.crc32(case_id.encode()) % (2 ** 31)


def cotangent(shape, seed):
    """Integer-valued float32 cotangent in [-2, 2]."""
    rs = np.random.RandomState(seed)
    return rs.randint(-2, 3, size=shape).astype(np.float32)


def _u(lo, hi, *shape):
    return lambda rs: [rs.uniform(lo, hi, shape).astype(np.float32)]


def _n(*shapes):
    return lambda rs: [rs.standard_normal(s).astype(np.float32)
                       for s in shapes]


def _away(rs, shape, lo=0.2, hi=3.0):
    """Values with |x| in [lo, hi], random signs."""
    return (rs.uniform(lo, hi, shape)
            * rs.choice([-1.0, 1.0], shape)).astype(np.float32)


def _halves(rs):
    """Exact halves (the rounding ties) and random values."""
    ties = np.arange(-3.5, 4.0, 0.5, dtype=np.float32)
    return [np.concatenate([ties, rs.uniform(-4, 4, 17).astype(np.float32)])
            .reshape(4, 8)]


def _ties(rs, shape=(3, 10)):
    return [rs.randint(0, 4, shape).astype(np.float32)]


def _zeros_in(rs, shape=(4, 6)):
    x = rs.standard_normal(shape).astype(np.float32)
    x[rs.rand(*shape) < 0.3] = 0.0
    return x


def _spd(rs, b=2, n=4):
    a = rs.standard_normal((b, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _lower(rs, b=2, n=4):
    a = np.tril(rs.standard_normal((b, n, n)).astype(np.float32))
    idx = np.arange(n)
    a[:, idx, idx] = rs.uniform(1.0, 2.0, (b, n)).astype(np.float32)
    return a


def _f(*arrays):
    return [np.asarray(a, dtype=np.float32) for a in arrays]


C = Case
_SPECIAL_UNARY = {
    "arccos": (-0.9, 0.9), "arcsin": (-0.9, 0.9), "arctanh": (-0.9, 0.9),
    "arccosh": (1.1, 3.0), "arcsinh": (-3.0, 3.0), "arctan": (-3.0, 3.0),
    "sin": (-3.0, 3.0), "cos": (-3.0, 3.0), "tan": (-1.2, 1.2),
    "sinh": (-2.0, 2.0), "cosh": (-2.0, 2.0), "erf": (-2.0, 2.0),
    "erfinv": (-0.9, 0.9), "expm1": (-2.0, 2.0), "log1p": (-0.5, 2.0),
    "log2": (0.1, 5.0), "log10": (0.1, 5.0), "rsqrt": (0.1, 5.0),
    "gamma": (0.2, 4.5), "gammaln": (0.2, 6.0),
}

CASES = []
for _op, (_lo, _hi) in _SPECIAL_UNARY.items():
    CASES.append(C(_op, "math", _u(_lo, _hi, 3, 5), tol=SPECIAL))
CASES += [
    C("cbrt", "math", lambda rs: [_away(rs, (3, 5))], tol=SPECIAL),
    C("rcbrt", "math", lambda rs: [_away(rs, (3, 5))], tol=SPECIAL),
    C("reciprocal", "math", lambda rs: [_away(rs, (3, 5))]),
    C("degrees", "math", _n((3, 5))),
    C("radians", "math", _n((3, 5))),
    C("softsign", "math", _n((3, 5))),
    C("relu", "math", lambda rs: [_away(rs, (3, 5))], tag="Relu"),
    C("identity", "math", _n((3, 5))),
    C("BlockGrad", "math", _n((3, 5))),
    C("make_loss", "math", _n((3, 5))),
    C("smooth_l1", "math", lambda rs: [_away(rs, (4, 6), 0.05, 3.0)],
      {"scalar": 1.0}),
    C("smooth_l1", "math", lambda rs: [_away(rs, (4, 6), 0.05, 3.0)],
      {"scalar": 2.0}, tag="s2"),
    C("logical_not", "math", lambda rs: [_zeros_in(rs)], tol=EXACT,
      grad=[]),
    C("add_n", "math", _n((3, 4), (3, 4), (3, 4)), {"num_args": 3}),
]
for _op in ("ceil", "floor", "trunc", "fix", "rint"):
    CASES.append(C(_op, "math", _halves, tol=EXACT))
for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul",
            "broadcast_minimum", "broadcast_hypot", "arctan2", "_hypot"):
    CASES.append(C(_op, "math", lambda rs: [_away(rs, (3, 4)),
                                            _away(rs, (1, 4))],
                   tol=SPECIAL if _op in ("arctan2",) else ARITH))
CASES += [
    C("broadcast_div", "math", lambda rs: [_away(rs, (3, 4)),
                                           _away(rs, (1, 4))]),
    C("broadcast_power", "math", lambda rs: [rs.uniform(0.5, 2.0, (3, 4))
                                             .astype(np.float32),
                                             _away(rs, (1, 4), 0.2, 2.0)],
      tol=SPECIAL),
    C("_scatter_elemwise_div", "math",
      lambda rs: [_away(rs, (3, 4)), _away(rs, (3, 4))]),
]
for _op in ("broadcast_logical_and", "broadcast_logical_or",
            "broadcast_logical_xor"):
    CASES.append(C(_op, "math", lambda rs: [_zeros_in(rs, (3, 4)),
                                            _zeros_in(rs, (1, 4))],
                   tol=EXACT, grad=[]))
for _op in ("_logical_and_scalar", "_logical_or_scalar",
            "_logical_xor_scalar"):
    CASES.append(C(_op, "math", lambda rs: [_zeros_in(rs)], {"scalar": 1.0},
                   tol=EXACT, grad=[]))
    CASES.append(C(_op, "math", lambda rs: [_zeros_in(rs)], {"scalar": 0.0},
                   tol=EXACT, grad=[], tag="s0"))
CASES += [
    C("_maximum_scalar", "math", lambda rs: [_away(rs, (3, 5))],
      {"scalar": 0.5}),
    C("_minimum_scalar", "math", lambda rs: [_away(rs, (3, 5))],
      {"scalar": 0.5}),
    C("_hypot_scalar", "math", _n((3, 5)), {"scalar": 1.5}),
    C("_scatter_plus_scalar", "math", _n((3, 5)), {"scalar": 1.5}),
    C("_scatter_minus_scalar", "math", _n((3, 5)), {"scalar": 1.5}),
    C("_contrib_quadratic", "math", _n((3, 5)),
      {"a": 0.5, "b": -1.25, "c": 2.0}),
    C("round", "math", _halves, tol=EXACT),
    C("prod", "math", lambda rs: [_zeros_in(rs, (4, 6))], {"axis": 1}),
    C("prod", "math", lambda rs: [rs.uniform(0.5, 1.5, (2, 3, 4))
                                  .astype(np.float32)],
      {"axis": (0, 2), "keepdims": True}, tag="axes"),
    C("nansum", "math", lambda rs: [np.where(rs.rand(4, 6) < 0.3, np.nan,
                                             rs.standard_normal((4, 6)))
                                    .astype(np.float32)], {"axis": 0}),
    C("nanprod", "math", lambda rs: [np.where(rs.rand(4, 6) < 0.3, np.nan,
                                              rs.uniform(0.5, 1.5, (4, 6)))
                                     .astype(np.float32)], {"axis": 1}),
    C("IdentityAttachKLSparseReg", "nn", _u(0.05, 0.95, 6, 5),
      {"sparseness_target": 0.1, "penalty": 0.01}),
]


# -- indexing and shape ------------------------------------------------------
def _idx(*vals):
    return np.asarray(vals, dtype=np.float32)


CASES += [
    C("slice", "index", _n((4, 5, 3)), {"begin": (1, None),
                                        "end": (3, 4)}, tol=EXACT),
    C("slice", "index", _n((4, 5, 3)), {"begin": (None, 3, 0),
                                        "end": (None, 0, 3),
                                        "step": (-1, -2, 2)},
      tol=EXACT, tag="neg"),
    C("slice_like", "index", _n((4, 5, 3), (2, 3, 3)), {"axes": (0, 1)},
      tol=EXACT, grad=[0]),
    C("take", "index", lambda rs: [rs.standard_normal((4, 3))
                                   .astype(np.float32),
                                   _idx(-5, -1, 0, 3, 4, 7)],
      {"mode": "clip"}, tol=EXACT, grad=[0]),
    C("take", "index", lambda rs: [rs.standard_normal((4, 3))
                                   .astype(np.float32),
                                   _idx(-5, -1, 0, 3, 4, 7)],
      {"mode": "wrap"}, tol=EXACT, grad=[0], tag="wrap"),
    C("take", "index", lambda rs: [rs.standard_normal((4, 3))
                                   .astype(np.float32),
                                   np.asarray([[-5, -1], [0, 3], [4, 7]],
                                              np.float32)],
      {"mode": "raise"}, tol=EXACT, grad=[0], tag="fill"),
    C("take", "index", lambda rs: [rs.standard_normal((2, 5, 3))
                                   .astype(np.float32),
                                   _idx(4, 0, 2, 2, 9)],
      {"axis": 1}, tol=EXACT, grad=[0], tag="axis1"),
    C("batch_take", "index", lambda rs: [rs.standard_normal((5, 3))
                                         .astype(np.float32),
                                         _idx(-4, -1, 2, 3, 0)],
      tol=EXACT, grad=[0]),
    C("gather_nd", "index", lambda rs: [rs.standard_normal((4, 3, 2))
                                        .astype(np.float32),
                                        np.asarray([[-5, -1, 0, 4, 2],
                                                    [0, -4, 5, 1, 2]],
                                                   np.float32)],
      tol=EXACT, grad=[0]),
    C("scatter_nd", "index", lambda rs: [rs.standard_normal((5, 2))
                                         .astype(np.float32),
                                         np.asarray([[-1, 0, 4, 1, 2],
                                                     [0, -1, 1, 5, 1]],
                                                    np.float32)],
      {"shape": (3, 3, 2)}, tol=EXACT, grad=[0]),
    C("_scatter_set_nd", "index", lambda rs: [
        rs.standard_normal((3, 3)).astype(np.float32),
        rs.standard_normal((4,)).astype(np.float32),
        np.asarray([[-1, 0, 7, 1], [0, -1, 1, 2]], np.float32)],
      {"shape": (3, 3)}, tol=EXACT, grad=[0, 1]),
    C("tile", "index", _n((2, 3)), {"reps": (2, 1, 3)}, tol=EXACT),
    C("repeat", "index", _n((2, 3)), {"repeats": 2, "axis": 1}, tol=EXACT),
    C("repeat", "index", _n((2, 3)), {"repeats": 3}, tol=EXACT,
      tag="flat"),
    C("reverse", "index", _n((2, 3, 4)), {"axis": (0, 2)}, tol=EXACT),
    C("shape_array", "index", _n((2, 3, 4)), tol=EXACT, grad=[]),
    C("size_array", "index", _n((2, 3, 4)), tol=EXACT, grad=[]),
    C("diag", "index", _n((4, 5)), {"k": 1}, tol=EXACT),
    C("diag", "index", _n((4,)), {"k": -1}, tol=EXACT, tag="vec"),
    C("diag", "index", _n((3, 4, 2)), tol=EXACT, tag="3d"),
    C("depth_to_space", "index", _n((2, 8, 3, 2)), {"block_size": 2},
      tol=EXACT),
    C("space_to_depth", "index", _n((2, 2, 4, 6)), {"block_size": 2},
      tol=EXACT),
    C("batch_dot", "index", _n((3, 4, 5), (3, 5, 2))),
    C("batch_dot", "index", _n((3, 5, 4), (3, 2, 5)),
      {"transpose_a": True, "transpose_b": True}, tag="tt"),
    C("L2Normalization", "index", _n((3, 4, 2, 2)), {"mode": "instance"}),
    C("L2Normalization", "index", _n((3, 4, 2, 2)), {"mode": "channel"},
      tag="channel"),
    C("L2Normalization", "index", _n((3, 4, 2, 2)), {"mode": "spatial"},
      tag="spatial"),
    C("sequence_mask", "index", lambda rs: [
        rs.standard_normal((5, 3, 2)).astype(np.float32), _idx(5, 1, 3)],
      {"use_sequence_length": True, "value": -1.5}, tol=EXACT, grad=[0]),
    C("sequence_mask", "index", lambda rs: [
        rs.standard_normal((3, 5, 2)).astype(np.float32), _idx(2, 5, 0)],
      {"use_sequence_length": True, "axis": 1}, tol=EXACT, grad=[0],
      tag="axis1"),
    C("sequence_last", "index", lambda rs: [
        rs.standard_normal((5, 3, 2)).astype(np.float32), _idx(5, 1, 3)],
      {"use_sequence_length": True}, tol=EXACT, grad=[0]),
    C("sequence_last", "index", _n((5, 3, 2)), tol=EXACT, tag="nolen"),
    C("sequence_reverse", "index", lambda rs: [
        rs.standard_normal((5, 3, 2)).astype(np.float32), _idx(5, 1, 3)],
      {"use_sequence_length": True}, tol=EXACT, grad=[0]),
    C("broadcast_to", "index", _n((1, 3, 1)), {"shape": (2, 0, 4)},
      tol=EXACT),
    C("broadcast_axis", "index", _n((1, 3, 1)), {"axis": (0, 2),
                                                 "size": (2, 4)},
      tol=EXACT),
    C("broadcast_like", "index", _n((1, 3), (4, 3)), tol=EXACT, grad=[0]),
    C("reshape_like", "index", _n((2, 6), (3, 4)), tol=EXACT, grad=[0]),
    C("_identity_with_attr_like_rhs", "index", _n((2, 6), (3, 4)),
      tol=EXACT, grad=[0]),
    C("_slice_assign", "index", _n((4, 5), (2, 3)),
      {"begin": (1, 0), "end": (3, 5), "step": (1, 2)}, tol=EXACT),
    C("_slice_assign", "index", _n((4, 5), (2, 5)),
      {"begin": (3,), "end": (0,), "step": (-2,)}, tol=EXACT, tag="neg"),
    C("_slice_assign_scalar", "index", _n((4, 5)),
      {"scalar": 2.5, "begin": (None, 1), "end": (2, 4)}, tol=EXACT),
    C("argmax_channel", "index", lambda rs: [rs.permutation(24).reshape(
        2, 3, 4).astype(np.float32)], tol=EXACT, grad=[]),
]


# -- sorting and creation ----------------------------------------------------
CASES += [
    C("sort", "sort", _ties, tol=EXACT),
    C("sort", "sort", _ties, {"is_ascend": False, "axis": 0}, tol=EXACT,
      tag="desc0"),
    C("sort", "sort", _ties, {"axis": None}, tol=EXACT, tag="flat"),
    C("argsort", "sort", _ties, tol=EXACT, grad=[]),
    C("argsort", "sort", _ties, {"is_ascend": False}, tol=EXACT, grad=[],
      tag="desc"),
    C("argsort", "sort", _ties, {"axis": 0, "dtype": "int32"}, tol=EXACT,
      grad=[], tag="axis0"),
    C("topk", "sort", _ties, {"k": 4}, tol=EXACT, grad=[]),
    C("topk", "sort", _ties, {"k": 4, "is_ascend": True}, tol=EXACT,
      grad=[], tag="asc"),
    C("topk", "sort", _ties, {"k": 2, "axis": 0, "ret_typ": "value"},
      tol=EXACT, grad=[], tag="value0"),
    C("topk", "sort", _ties, {"k": 3, "ret_typ": "mask"}, tol=EXACT,
      grad=[], tag="mask"),
    C("topk", "sort", _ties, {"k": 3, "ret_typ": "both"}, tol=EXACT,
      grad=[], tag="both"),
    C("topk", "sort", lambda rs: [rs.standard_normal((4, 33))
                                  .astype(np.float32)], {"k": 5},
      tol=EXACT, grad=[], tag="wide"),
    C("_zeros", "sort", lambda rs: [], {"shape": (2, 3)}, tol=EXACT,
      grad=[]),
    C("_ones", "sort", lambda rs: [], {"shape": (2, 3), "dtype": "int32"},
      tol=EXACT, grad=[]),
    C("_full", "sort", lambda rs: [], {"shape": (2, 3), "value": 2.5},
      tol=EXACT, grad=[]),
    C("_arange", "sort", lambda rs: [], {"start": 1, "stop": 7,
                                         "step": 1.5, "repeat": 2},
      tol=EXACT, grad=[]),
    C("_arange", "sort", lambda rs: [], {"start": 5}, tol=EXACT, grad=[],
      tag="stop"),
    C("_eye", "sort", lambda rs: [], {"N": 3, "M": 5, "k": 1}, tol=EXACT,
      grad=[]),
    # jnp.linspace's formula; XLA fuses its float32 arithmetic on the
    # CPU, so the values agree to an ulp (1e-6), not bit for bit
    C("_linspace", "sort", lambda rs: [], {"start": -1.0, "stop": 1.0,
                                           "num": 7}, tol=1e-6, grad=[]),
    C("_linspace", "sort", lambda rs: [], {"start": 0.0, "stop": 3.0,
                                           "num": 6, "endpoint": False},
      tol=1e-6, grad=[], tag="open"),
]


# -- linalg -------------------------------------------------------------------
CASES += [
    C("linalg_gemm", "linalg", _n((2, 3, 4), (2, 4, 5), (2, 3, 5)),
      {"alpha": 0.5, "beta": 2.0}, tol=SPECIAL),
    C("linalg_gemm", "linalg", _n((2, 4, 3), (2, 5, 4), (2, 3, 5)),
      {"transpose_a": True, "transpose_b": True}, tol=SPECIAL, tag="tt"),
    C("linalg_gemm2", "linalg", _n((2, 3, 4), (2, 4, 5)), {"alpha": 1.5},
      tol=SPECIAL),
    C("linalg_gemm2", "linalg", _n((3, 4), (5, 4)), {"transpose_b": True},
      tol=SPECIAL, tag="t"),
    C("linalg_potrf", "linalg", lambda rs: [_spd(rs)], tol=SPECIAL),
    C("linalg_potri", "linalg", lambda rs: [_lower(rs)], tol=SPECIAL),
    C("linalg_trmm", "linalg", lambda rs: [_lower(rs), rs.standard_normal(
        (2, 4, 3)).astype(np.float32)], {"alpha": 2.0}, tol=SPECIAL),
    C("linalg_trmm", "linalg", lambda rs: [_lower(rs), rs.standard_normal(
        (2, 3, 4)).astype(np.float32)], {"transpose": True,
                                         "rightside": True, "lower": False},
      tol=SPECIAL, tag="tr"),
    C("linalg_trsm", "linalg", lambda rs: [_lower(rs), rs.standard_normal(
        (2, 4, 3)).astype(np.float32)], {"alpha": 2.0}, tol=SPECIAL),
    C("linalg_trsm", "linalg", lambda rs: [_lower(rs), rs.standard_normal(
        (2, 4, 3)).astype(np.float32)], {"transpose": True}, tol=SPECIAL,
      tag="t"),
    C("linalg_trsm", "linalg", lambda rs: [_lower(rs), rs.standard_normal(
        (2, 3, 4)).astype(np.float32)], {"rightside": True}, tol=SPECIAL,
      tag="r"),
    C("linalg_trsm", "linalg", lambda rs: [
        np.ascontiguousarray(_lower(rs).transpose(0, 2, 1)),
        rs.standard_normal((2, 3, 4)).astype(np.float32)],
      {"rightside": True, "transpose": True, "lower": False}, tol=SPECIAL,
      tag="rtu"),
    C("linalg_sumlogdiag", "linalg", lambda rs: [_spd(rs)], tol=SPECIAL),
    C("linalg_syrk", "linalg", _n((2, 3, 4)), {"alpha": 0.5}, tol=SPECIAL),
    C("linalg_syrk", "linalg", _n((2, 3, 4)), {"transpose": True},
      tol=SPECIAL, tag="t"),
    C("linalg_gelqf", "linalg", _n((2, 3, 5)), tol=SPECIAL),
    C("linalg_syevd", "linalg", lambda rs: [_spd(rs)], tol=SPECIAL,
      check="syevd"),
    C("khatri_rao", "linalg", _n((2, 3), (4, 3), (2, 3)), tol=SPECIAL),
]


# -- legacy and spatial nn ----------------------------------------------------
def _rois(rs):
    return [rs.standard_normal((2, 3, 6, 7)).astype(np.float32),
            np.asarray([[0, 0.0, 0.0, 6.0, 5.0], [1, 1.5, 0.5, 4.5, 3.5],
                        [0, 2.0, 2.0, 2.0, 2.0], [1, 3.0, 1.0, 8.0, 9.0]],
                       np.float32)]


def _grid(rs):
    return [rs.standard_normal((2, 3, 5, 6)).astype(np.float32),
            rs.uniform(-1.2, 1.2, (2, 2, 4, 3)).astype(np.float32)]


def _affine(rs):
    base = np.tile(np.asarray([0.9, 0.1, 0.05, -0.1, 0.8, -0.05],
                              np.float32), (2, 1))
    return [rs.standard_normal((2, 3, 5, 6)).astype(np.float32),
            base + 0.05 * rs.standard_normal((2, 6)).astype(np.float32)]


def bilinear_weight(c=3, scale=2):
    """The (c, 1, k, k) bilinear kernel of ``UpSampling`` by ``scale``
    (MXNet's ``Bilinear`` initializer)."""
    k = 2 * scale - scale % 2
    f = np.ceil(k / 2.0)
    cc = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - cc)) * (1 - abs(j / f - cc))
    return np.tile(w, (c, 1, 1, 1)).astype(np.float32)


CASES += [
    C("SoftmaxActivation", "nn", _n((3, 4, 2))),
    C("SoftmaxActivation", "nn", _n((3, 4, 2)), {"mode": "channel"},
      tag="channel"),
    C("softmax_cross_entropy", "nn", lambda rs: [
        rs.standard_normal((5, 4)).astype(np.float32), _idx(0, 3, 1, 1, 2)],
      grad=[0]),
    C("UpSampling", "nn", _n((2, 3, 3, 4)), {"scale": 2}, tol=EXACT),
    C("UpSampling", "nn", _n((2, 3, 3, 4), (2, 2, 3, 4)),
      {"scale": 2, "num_args": 2}, tol=EXACT, tag="concat"),
    C("UpSampling", "nn", lambda rs: [
        rs.standard_normal((2, 3, 4, 5)).astype(np.float32),
        bilinear_weight()], {"scale": 2, "sample_type": "bilinear",
                                "num_filter": 3}, tag="bilinear"),
    C("ROIPooling", "nn", _rois, {"pooled_size": (2, 3),
                                  "spatial_scale": 1.0}, grad=[0]),
    C("ROIPooling", "nn", _rois, {"pooled_size": (2, 2),
                                  "spatial_scale": 0.5}, grad=[0],
      tag="half"),
    C("GridGenerator", "nn", lambda rs: [_affine(rs)[1]],
      {"transform_type": "affine", "target_shape": (4, 5)}, grad=[]),
    C("GridGenerator", "nn", lambda rs: [0.1 * rs.standard_normal(
        (2, 2, 4, 5)).astype(np.float32)],
      {"transform_type": "warp", "target_shape": (4, 5)}, grad=[],
      tag="warp"),
    C("BilinearSampler", "nn", _grid),
    C("SpatialTransformer", "nn", _affine, {"target_shape": (4, 5)}),
    C("BatchNorm", "nn", lambda rs: _f(
        rs.standard_normal((4, 3, 2, 2)), rs.uniform(0.5, 1.5, 3),
        rs.standard_normal(3), rs.standard_normal(3),
        rs.uniform(0.5, 1.5, 3)),
      {"fix_gamma": False, "training": True}, grad=[0, 1, 2],
      tag="v1"),
    C("Convolution", "nn", _n((2, 3, 5, 5), (4, 3, 3, 3), (4,)),
      {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}, tol=SPECIAL,
      tag="v1"),
    C("Pooling", "nn", _n((2, 3, 6, 6)),
      {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
      tag="v1"),
]


# -- the optimizer updates: no gradient; the cast weights one ulp -------------
def _mp(rs, mom=False, dtype="bfloat16"):
    w32 = rs.standard_normal((4, 6)).astype(np.float32)
    g = rs.standard_normal((4, 6)).astype(np.float32)
    out = [w32, g] + ([0.1 * rs.standard_normal((4, 6)).astype(np.float32)]
                      if mom else []) + [w32]
    return out


CASES += [
    C("mp_sgd_update", "math", _mp, {"lr": 0.1, "wd": 0.01,
                                     "rescale_grad": 0.5,
                                     "clip_gradient": 0.8}, grad=[],
      check="mp:bfloat16"),
    C("mp_sgd_mom_update", "math", lambda rs: _mp(rs, True),
      {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, grad=[],
      check="mp:float16", tag="fp16"),
]

# the samplers: drawn, not compared element by element; each held to the
# distribution ``sampler_dists`` gives (canonical name: (attrs, kind))
SAMPLERS = {
    "_random_uniform": ({"low": -1.0, "high": 3.0}, "uniform"),
    "_random_normal": ({"loc": 1.0, "scale": 2.0}, "normal"),
    "_random_gamma": ({"alpha": 2.5, "beta": 1.5}, "gamma"),
    "_random_exponential": ({"lam": 2.0}, "expon"),
    "_random_poisson": ({"lam": 3.5}, "poisson"),
    "_random_negative_binomial": ({"k": 3, "p": 0.4}, "nbinom"),
    "_random_generalized_negative_binomial": ({"mu": 2.0, "alpha": 0.5},
                                              "gnbinom"),
    "_sample_uniform": ({}, "uniform"),
    "_sample_normal": ({}, "normal"),
    "_sample_gamma": ({}, "gamma"),
    "_sample_exponential": ({}, "expon"),
    "_sample_poisson": ({}, "poisson"),
    "_sample_negative_binomial": ({}, "nbinom"),
    "_sample_generalized_negative_binomial": ({}, "gnbinom"),
    "_sample_multinomial": ({}, "multinomial"),
    "_shuffle": ({}, "shuffle"),
    "_sample_unique_zipfian": ({"range_max": 1000}, "zipfian"),
}

# the per-element samplers' parameter inputs: one list per input, one
# entry per row of draws
SAMPLER_PARAMS = {
    "uniform": ([0.0, -1.0], [1.0, 2.0]),
    "normal": ([0.0, 1.5], [1.0, 0.5]),
    "gamma": ([0.7, 3.0], [1.0, 0.5]),
    "expon": ([1.0, 2.5],),
    "poisson": ([0.5, 4.0],),
    "nbinom": ([2.0, 5.0], [0.3, 0.6]),
    "gnbinom": ([1.0, 3.0], [0.3, 0.8]),
}
MULTINOMIAL_PROBS = [0.1, 0.2, 0.3, 0.4]


def _scipy_dist(kind, *p):
    import scipy.stats as st
    if kind == "uniform":
        return st.uniform(loc=p[0], scale=p[1] - p[0])
    if kind == "normal":
        return st.norm(loc=p[0], scale=p[1])
    if kind == "gamma":
        return st.gamma(a=p[0], scale=p[1])
    if kind == "expon":
        return st.expon(scale=1.0 / p[0])
    if kind == "poisson":
        return st.poisson(p[0])
    if kind == "nbinom":
        return st.nbinom(n=p[0], p=p[1])
    r = 1.0 / p[1]                       # gnbinom (mu, alpha)
    return st.nbinom(n=r, p=r / (r + p[0]))


_RANDOM_ATTRS = {"uniform": ("low", "high"), "normal": ("loc", "scale"),
                 "gamma": ("alpha", "beta"), "expon": ("lam",),
                 "poisson": ("lam",), "nbinom": ("k", "p"),
                 "gnbinom": ("mu", "alpha")}


def sampler_dists(name):
    """The scipy distribution of each row a sampler draws: a ``_random_*``
    op's one (its ``SAMPLERS`` attrs), a ``_sample_*`` op's one per row
    of ``SAMPLER_PARAMS``, multinomial over ``MULTINOMIAL_PROBS``, the
    log-uniform zipfian over [0, range_max); none for ``_shuffle``."""
    import scipy.stats as st
    attrs, kind = SAMPLERS[name]
    if name.startswith("_random_"):
        return [_scipy_dist(kind, *(attrs[a] for a in _RANDOM_ATTRS[kind]))]
    if kind in SAMPLER_PARAMS:
        return [_scipy_dist(kind, *row)
                for row in zip(*SAMPLER_PARAMS[kind])]
    if kind == "multinomial":
        return [st.rv_discrete(values=(np.arange(len(MULTINOMIAL_PROBS)),
                                       MULTINOMIAL_PROBS))]
    if kind == "zipfian":
        k = np.arange(attrs["range_max"])
        pmf = np.log((k + 2.0) / (k + 1.0)) / np.log(k.size + 1.0)
        return [st.rv_discrete(values=(k, pmf / pmf.sum()))]
    return []


# ---------------------------------------------------------------------------
# contrib (ROADMAP A2): the SSD box ops and the detection / vision ops.
# Boxes are drawn with duplicates and scores with equal values, so every
# sort meets ties; the class ids, keep masks and matches compare exactly
# (integers at ARITH), boxes and targets at ARITH.
# ---------------------------------------------------------------------------
def _corners(rs, n, dup=2):
    """``n`` corner boxes in [0, 1], the last ``dup`` copies of the
    first ones."""
    xy = rs.uniform(0.0, 0.6, (n, 2))
    wh = rs.uniform(0.1, 0.4, (n, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    b[n - dup:] = b[:dup]
    return b


def _anchor(rs, a=24):
    return _corners(rs, a, dup=3)[None]


def _labels(rs, b=3, l=3):
    """(b, l, 5) rows [cls, box], -1-padded: a padded slot in the first
    item, a duplicate box in the second, no ground truth in the last."""
    lab = np.full((b, l, 5), -1.0, np.float32)
    for i in range(b - 1):
        k = l - 1 if i == 0 else l
        lab[i, :k, 0] = rs.randint(0, 3, k)
        lab[i, :k, 1:] = _corners(rs, k, dup=1 if i else 0)
    return lab


def _mbt(rs):
    anchor, label = _anchor(rs), _labels(rs)
    a = anchor.shape[1]
    anchor[0, 5] = label[1, 0, 1:]           # an anchor on a ground truth
    cls = rs.standard_normal((3, 4, a)).astype(np.float32)
    cls[:, :, 7] = cls[:, :, 2]              # equal background probs
    return [anchor, label, cls]


def _mbd(rs, a=24):
    logits = rs.standard_normal((2, 4, a)).astype(np.float32)
    logits[:, :, 9] = logits[:, :, 3]        # equal scores, equal boxes
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (0.3 * rs.standard_normal((2, a, 4))).astype(np.float32)
    loc[:, 9] = loc[:, 3]
    anchor = _anchor(rs, a)
    anchor[0, 9] = anchor[0, 3]
    return [prob, loc.reshape(2, a * 4), anchor]


def _nms_records(rs, lead=(2, 3), n=12, center=False):
    """(..., n, 6) records [id, score, box]; duplicates and equal scores."""
    rec = np.zeros(lead + (n, 6), np.float32)
    rec[..., 0] = rs.randint(0, 2, lead + (n,))
    rec[..., 1] = np.round(rs.uniform(0, 1, lead + (n,)), 1)
    for ix in np.ndindex(*lead):
        bx = _corners(rs, n, dup=3)
        if center:
            bx = np.concatenate([(bx[:, :2] + bx[:, 2:]) / 2,
                                 bx[:, 2:] - bx[:, :2]], 1)
        rec[ix + (slice(None), slice(2, 6))] = bx
        rec[ix + (slice(n - 3, n), slice(0, 2))] = rec[ix + (slice(0, 3),
                                                           slice(0, 2))]
    return rec


def _box_pairs(rs, center=False):
    lhs = np.stack([_corners(rs, 5, dup=1) for _ in range(2)])
    rhs = np.stack([_corners(rs, 6, dup=0) for _ in range(2)])
    rhs[:, 0] = lhs[:, 0]                    # a duplicate across sides
    if center:
        lhs, rhs = (np.concatenate([(x[..., :2] + x[..., 2:]) / 2,
                                    x[..., 2:] - x[..., :2]], -1)
                    for x in (lhs, rhs))
    return [lhs.astype(np.float32), rhs.astype(np.float32)]


def _proposal(rs, a=6, h=5, w=6, b=2):
    logits = rs.standard_normal((b, 2, a, h, w)).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).reshape(b, 2 * a, h, w)
    prob[:, a + 1] = prob[:, a]              # equal fg scores
    deltas = (0.2 * rs.standard_normal((b, 4 * a, h, w))).astype(np.float32)
    info = np.array([[40, 48, 1.0], [36, 44, 1.5]], np.float32)[:b]
    return [prob.astype(np.float32), deltas, info]


_PROPOSAL = {"scales": (2, 4), "ratios": (0.5, 1, 2), "feature_stride": 8,
             "rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 10,
             "threshold": 0.7, "rpn_min_size": 4}


def _psroi_rois(rs, r=4, b=2, h=8, w=9, scale=0.5):
    x1 = rs.uniform(0, w / scale * 0.5, r)
    y1 = rs.uniform(0, h / scale * 0.5, r)
    x2 = x1 + rs.uniform(2, w / scale * 0.5, r)
    y2 = y1 + rs.uniform(2, h / scale * 0.5, r)
    rois = np.stack([rs.randint(0, b, r), x1, y1, x2, y2], 1)
    return rois.astype(np.float32)


def _psroi(rs, trans=True):
    data = rs.standard_normal((2, 12, 8, 9)).astype(np.float32)
    ins = [data, _psroi_rois(rs)]
    if trans:
        ins.append((0.5 * rs.standard_normal((4, 2, 2, 2)))
                   .astype(np.float32))
    return ins


def _deform(rs):
    data = rs.standard_normal((2, 4, 6, 7)).astype(np.float32)
    offset = (1.5 * rs.standard_normal((2, 2 * 2 * 9, 6, 7))) \
        .astype(np.float32)
    weight = (0.3 * rs.standard_normal((6, 2, 3, 3))).astype(np.float32)
    bias = rs.standard_normal(6).astype(np.float32)
    return [data, offset, weight, bias]


def _deform_strided(rs):
    """Stride 2, dilation (1, 2), no padding: a (2, 2) output, one
    deformable group, no bias."""
    data = rs.standard_normal((2, 4, 6, 7)).astype(np.float32)
    offset = (1.5 * rs.standard_normal((2, 18, 2, 2))).astype(np.float32)
    weight = (0.3 * rs.standard_normal((6, 4, 3, 3))).astype(np.float32)
    return [data, offset, weight]


def _sketch(rs):
    data = rs.standard_normal((3, 10)).astype(np.float32)
    h = rs.randint(0, 6, (1, 10)).astype(np.float32)
    h[0, 4] = -1.0                           # out of range: dropped
    s = rs.choice([-1.0, 1.0], (1, 10)).astype(np.float32)
    return [data, h, s]


def _scores(rs, shape=(2, 5, 7)):
    return [np.round(rs.uniform(0, 1, shape), 1).astype(np.float32)]


_MB_ATTRS = {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5), "clip": True,
             "steps": (0.2, 0.25), "offsets": (0.4, 0.6)}
CASES += [
    C("MultiBoxPrior", "contrib", lambda rs: [np.zeros((1, 3, 4, 5),
                                                       np.float32)],
      _MB_ATTRS, grad=[]),
    C("MultiBoxPrior", "contrib", lambda rs: [np.zeros((2, 3, 3, 3),
                                                       np.float32)],
      {"sizes": (0.5,), "ratios": (1.0,)}, grad=[], tag="plain"),
    C("MultiBoxTarget", "contrib", _mbt,
      {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
       "negative_mining_thresh": 0.5, "minimum_negative_samples": 2},
      grad=[]),
    C("MultiBoxTarget", "contrib", _mbt,
      {"overlap_threshold": 0.3, "ignore_label": -2.0,
       "variances": (0.1, 0.1, 0.2, 0.2)}, grad=[], tag="nomine"),
    C("MultiBoxDetection", "contrib", _mbd,
      {"threshold": 0.2, "nms_threshold": 0.45, "nms_topk": 10}, grad=[]),
    C("MultiBoxDetection", "contrib", _mbd,
      {"threshold": 0.05, "nms_threshold": 0.3, "force_suppress": True,
       "clip": False}, grad=[], tag="force"),
    C("box_nms", "contrib", lambda rs: [_nms_records(rs)],
      {"overlap_thresh": 0.5, "coord_start": 2, "score_index": 1,
       "id_index": 0, "topk": 8, "valid_thresh": 0.1}, grad=[]),
    C("box_nms", "contrib", lambda rs: [_nms_records(rs, (4,),
                                                     center=True)],
      {"overlap_thresh": 0.4, "in_format": "center",
       "out_format": "corner"}, grad=[], tag="center"),
    C("box_nms", "contrib", lambda rs: [_nms_records(rs, (3,))],
      {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True,
       "out_format": "center"}, grad=[], tag="force"),
    C("_contrib_box_iou", "contrib", _box_pairs),
    C("_contrib_box_iou", "contrib", lambda rs: _box_pairs(rs, True),
      {"format": "center"}, tag="center"),
    C("_contrib_bipartite_matching", "contrib", _scores,
      {"threshold": 0.3}, grad=[]),
    C("_contrib_bipartite_matching", "contrib", _scores,
      {"is_ascend": True, "threshold": 0.6, "topk": 2}, grad=[],
      tag="ascend"),
    C("_contrib_bipartite_matching", "contrib",
      lambda rs: _scores(rs, (6, 4)), {"threshold": 0.5}, grad=[],
      tag="single"),
    C("Proposal", "contrib", _proposal,
      dict(_PROPOSAL, output_score=True), grad=[]),
    C("MultiProposal", "contrib", _proposal, _PROPOSAL, grad=[]),
    C("PSROIPooling", "contrib", lambda rs: _psroi(rs, False),
      {"spatial_scale": 0.5, "output_dim": 3, "pooled_size": 2,
       "group_size": 2}, grad=[0]),
    C("DeformablePSROIPooling", "contrib", _psroi,
      {"spatial_scale": 0.5, "output_dim": 3, "group_size": 2,
       "pooled_size": 2, "part_size": 2, "sample_per_part": 2,
       "trans_std": 0.1}, grad=[0, 2]),
    C("DeformablePSROIPooling", "contrib", lambda rs: _psroi(rs, False),
      {"spatial_scale": 0.5, "output_dim": 3, "group_size": 2,
       "pooled_size": 2, "sample_per_part": 3, "no_trans": True},
      grad=[0], tag="notrans"),
    C("DeformableConvolution", "contrib", _deform,
      {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2,
       "num_deformable_group": 2}, grad=[0, 1, 2, 3]),
    C("DeformableConvolution", "contrib", _deform_strided,
      {"kernel": (3, 3), "stride": (2, 2), "dilate": (1, 2),
       "num_filter": 6, "no_bias": True}, grad=[0, 1, 2], tag="nobias"),
    C("Correlation", "contrib", _n((2, 3, 7, 8), (2, 3, 7, 8)),
      {"kernel_size": 3, "max_displacement": 2, "pad_size": 2}),
    C("Correlation", "contrib", _n((2, 3, 7, 8), (2, 3, 7, 8)),
      {"kernel_size": 1, "max_displacement": 3, "stride1": 2, "stride2": 2,
       "pad_size": 3, "is_multiply": False}, tag="subtract"),
    C("Crop", "contrib", _n((2, 3, 6, 7)),
      {"h_w": (3, 4), "offset": (1, 2)}),
    C("Crop", "contrib", _n((2, 3, 6, 7), (2, 3, 4, 5)),
      {"num_args": 2, "center_crop": True}, grad=[0, 1], tag="like"),
    C("count_sketch", "contrib", _sketch, {"out_dim": 6}),
    C("fft", "contrib", _n((3, 8))),
    C("ifft", "contrib", _n((3, 16))),
]

# the canonical ops of the box cases (the rest of the contrib family is
# the vision ops)
BOX_OPS = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
           "box_nms", "_contrib_box_iou", "_contrib_bipartite_matching")

# the 32 names of ROADMAP A2 (the contrib detection and vision ops)
CONTRIB_NAMES = sorted([
    "Correlation", "Crop", "DeformableConvolution",
    "DeformablePSROIPooling", "MultiBoxDetection", "MultiBoxPrior",
    "MultiBoxTarget", "MultiProposal", "PSROIPooling", "Proposal",
    "_contrib_DeformableConvolution", "_contrib_DeformablePSROIPooling",
    "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
    "_contrib_MultiBoxTarget", "_contrib_MultiProposal",
    "_contrib_PSROIPooling", "_contrib_Proposal", "_contrib_box_nms",
    "_contrib_box_non_maximum_suppression", "_contrib_count_sketch",
    "_contrib_fft", "_contrib_ifft", "box_nms",
    "box_non_maximum_suppression", "count_sketch", "fft", "ifft",
    "box_iou", "_contrib_box_iou", "bipartite_matching",
    "_contrib_bipartite_matching"])

# the JAX package's op names the port does not carry yet, by the queue
# item of ROADMAP.md that takes them
STAY_MISSING = {
    "A6": sorted(["cast_storage", "sparse_retain", "_sparse_retain",
                  "square_sum", "_square_sum", "_sparse_adagrad_update"]),
    "A12": sorted([
        "_contrib_dequantize", "_contrib_quantize", "_contrib_quantized_conv",
        "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
        "_contrib_quantized_pooling", "_contrib_requantize", "dequantize",
        "quantize", "quantized_conv", "quantized_flatten",
        "quantized_fully_connected", "quantized_pooling", "requantize"]),
    "A9": sorted([
        "_cvcopyMakeBorder", "_cvimdecode", "_cvimread", "_cvimresize",
        "_image_normalize", "_image_to_tensor", "copyMakeBorder",
        "imdecode", "imread", "imresize", "image_normalize",
        "image_to_tensor"]),
}

# the 206 names this slice registered, each with its canonical op
NEW_NAMES = sorted("""
BatchNorm_v1 BilinearSampler BlockGrad Convolution_v1 CuDNNBatchNorm
ElementWiseSum GridGenerator IdentityAttachKLSparseReg L2Normalization
MakeLoss Pooling_v1 ROIPooling Relu SequenceLast SequenceMask
SequenceReverse SoftmaxActivation SpatialTransformer UpSampling _Div
_Minus _Mul _Plus _Power _add _arange _contrib_quadratic _copy
_crop_assign _crop_assign_scalar _eye _full _hypot _hypot_scalar
_identity_with_attr_like_rhs _linalg_gelqf _linalg_gemm _linalg_gemm2
_linalg_potrf _linalg_potri _linalg_sumlogdiag _linalg_syevd
_linalg_syrk _linalg_trmm _linalg_trsm _linspace _logical_and
_logical_and_scalar _logical_or _logical_or_scalar _logical_xor
_logical_xor_scalar _maximum_scalar _minimum _minimum_scalar _ones
_random_exponential _random_gamma _random_generalized_negative_binomial
_random_negative_binomial _random_normal _random_poisson _random_uniform
_sample_exponential _sample_gamma _sample_generalized_negative_binomial
_sample_multinomial _sample_negative_binomial _sample_normal
_sample_poisson _sample_uniform _sample_unique_zipfian
_scatter_elemwise_div _scatter_minus_scalar _scatter_plus_scalar
_scatter_set_nd _shuffle _slice_assign _slice_assign_scalar _sub _sum
_zeros add_n arange arccos arccosh arcsin arcsinh arctan arctan2 arctanh
argmax_channel argsort batch_dot batch_take broadcast_axes broadcast_axis
broadcast_hypot broadcast_like broadcast_logical_and broadcast_logical_or
broadcast_logical_xor broadcast_minimum broadcast_to cbrt ceil cos cosh
crop degrees depth_to_space diag erf erfinv expm1 eye fix flip floor full
gamma gammaln gather_nd hypot hypot_scalar identity khatri_rao
linalg_gelqf linalg_gemm linalg_gemm2 linalg_potrf linalg_potri
linalg_sumlogdiag linalg_syevd linalg_syrk linalg_trmm linalg_trsm
linspace log10 log1p log2 logical_and_scalar logical_not
logical_or_scalar logical_xor_scalar make_loss maximum_scalar minimum
minimum_scalar mp_sgd_mom_update mp_sgd_update multinomial nanprod nansum
normal ones prod quadratic radians random_exponential random_gamma
random_generalized_negative_binomial random_negative_binomial
random_normal random_poisson random_uniform rcbrt reciprocal repeat
reshape_like reverse rint round rsqrt sample_exponential sample_gamma
sample_generalized_negative_binomial sample_multinomial
sample_negative_binomial sample_normal sample_poisson sample_uniform
scatter_nd sequence_last sequence_mask sequence_reverse shape_array
shuffle sin sinh size_array slice slice_like smooth_l1 softmax_cross_entropy
softsign sort space_to_depth stop_gradient take tan tile topk trunc uniform
zeros
""".split())


def cases_of(name):
    """The cases that cover op name ``name`` (through its canonical op)."""
    from .registry import get_op
    canon = get_op(name).name
    return [c for c in CASES if get_op(c.op).name == canon]


def run_port(case, inputs, device="cpu", dtype=None, cot_seed=None):
    """The port's op of ``case`` on ``inputs`` (numpy) on ``device``,
    the floating inputs cast to ``dtype`` when given: ``(outputs,
    grads)`` as numpy (grads None without ``cot_seed`` or
    gradient positions), the gradient that of ``sum(out * cot)`` under
    the seeded integer cotangent of each output. Arrays keep their
    dtype, but bfloat16, which numpy lacks, becomes float32."""
    import torch
    from .registry import get_op
    from ..dtype import resolve_dtype
    fn = get_op(case.op).fn
    dt = resolve_dtype(dtype) if dtype is not None else None
    ts = []
    for a in inputs:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        ts.append(t)
    if case.check and case.check.startswith("mp:"):
        ts[0] = ts[0].to(resolve_dtype(case.check[3:]))
    pos = case.grad_positions(inputs) if cot_seed is not None else []
    leaves = [t.requires_grad_(i in pos) if i in pos else t
              for i, t in enumerate(ts)]
    attrs = dict(case.attrs)
    if not inputs:
        attrs["device"] = device
    with torch.enable_grad():
        res = fn(*leaves, **attrs)
        outs = res if isinstance(res, tuple) else (res,)
        grads = None
        if pos:
            total = 0
            for k, o in enumerate(outs):
                if not o.is_floating_point() or k in case.no_cot():
                    continue
                ct = torch.from_numpy(cotangent(tuple(o.shape),
                                                cot_seed + k)).to(o.device)
                total = total + torch.sum(o.float() * ct)
            want = [leaves[i] for i in pos]
            grads = torch.autograd.grad(total, want, allow_unused=True,
                                        materialize_grads=True) \
                if torch.is_tensor(total) and total.requires_grad \
                else [torch.zeros_like(w) for w in want]
    def to_np(t):
        t = t.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return [to_np(o) for o in outs], \
        None if grads is None else [to_np(g) for g in grads]


def padded_sequence_symbol(S, vocab=50, embed=16, hidden=16, classes=10):
    """A trainable symbol over padded sequences built from the slice's
    ops, through the symbol module ``S`` (either package's ``sym``):
    token ids ``data`` (T, N) and their lengths ``seq_len`` (N,) ->
    ``take`` from an embedding, ``SequenceMask``, a projection,
    self-attention by ``batch_dot`` and ``SoftmaxActivation``,
    ``L2Normalization``, the first step by ``slice``, ``tile``, the
    logits by ``linalg_gemm2``; heads: SoftmaxOutput, a ``MakeLoss`` of
    the mean ``smooth_l1`` of the logits, and a ``BlockGrad`` branch of
    their ``topk`` values."""
    ids = S.var("data")
    lens = S.var("seq_len")
    emb = S.take(S.var("emb_weight", shape=(vocab, embed)), ids, name="emb")
    m = S.SequenceMask(emb, lens, use_sequence_length=True, name="mask")
    h = S.FullyConnected(m, num_hidden=hidden, flatten=False, name="proj")
    q = S.transpose(h, axes=(1, 0, 2), name="q")
    att = S.SoftmaxActivation(S.batch_dot(q, q, transpose_b=True,
                                          name="scores"),
                              mode="channel", name="att")
    ctx = S.L2Normalization(S.batch_dot(att, q, name="ctx"), name="l2")
    first = S.Reshape(S.slice(ctx, begin=(None, 0, None),
                              end=(None, 1, None), name="first"),
                      shape=(0, -1), name="flat")
    feat = S.tile(first, reps=(1, 2), name="tile")
    logits = S.linalg_gemm2(feat, S.var("out_weight",
                                        shape=(2 * hidden, classes)),
                            name="logits")
    sm = S.SoftmaxOutput(logits, S.var("softmax_label"), name="softmax")
    reg = S.MakeLoss(S.mean(S.smooth_l1(logits, scalar=1.0, name="sl1"),
                            name="reg_mean"), name="reg")
    top = S.BlockGrad(S.topk(logits, k=3, ret_typ="value", name="top3"),
                      name="top")
    return S.Group([sm, reg, top])
