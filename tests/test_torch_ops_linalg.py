"""The op set's linalg ops (gemm, gemm2, potrf, potri, trmm, trsm in
each side and transpose, sumlogdiag, syrk, gelqf, syevd, khatri_rao)
against the JAX package's, on the CPU, on well-posed inputs (SPD as
B·Bᵀ + n·I, triangular factors with diagonals in [1, 2]): rtol 1e-4
forward, 1e-3 for the gradients. syevd's eigenvectors are compared up to
each row's sign, and its gradient flows from the eigenvalues alone."""
import pytest

from torch_ops_parity import backward_cases, check_case, forward_cases

FAMILY = "linalg"


@pytest.mark.parametrize("case", forward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", backward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_backward(case):
    check_case(case, backward=True)
