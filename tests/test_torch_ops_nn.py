"""The op set's legacy and spatial nn ops (SoftmaxActivation,
softmax_cross_entropy, UpSampling nearest / concat / bilinear,
ROIPooling, GridGenerator, BilinearSampler, SpatialTransformer, the
KL sparsity regularizer's custom gradient, and the v1 / cuDNN names of
BatchNorm, Convolution and Pooling) against the JAX package's, on the
CPU: forward at rtol 1e-5 (1e-4 for the convolution, exact for nearest
upsampling), gradients under one integer cotangent at ten times it."""
import pytest

from torch_ops_parity import backward_cases, check_case, forward_cases

FAMILY = "nn"


@pytest.mark.parametrize("case", forward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_forward(case):
    check_case(case, backward=False)


@pytest.mark.parametrize("case", backward_cases(FAMILY),
                         ids=lambda c: c.id)
def test_backward(case):
    check_case(case, backward=True)
