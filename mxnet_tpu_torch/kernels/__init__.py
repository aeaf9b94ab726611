"""Hand-written Hopper kernels of the port.

- ``csrc/bn_relu_conv1x1.cu`` (CUDA C++, ``sm_90a``): the fused
  BN-apply+ReLU+1x1-conv, counterpart of the TPU kernel
  ``_make_nchw_kernel``; built by ``build.py`` and bound with ``ctypes``.
- ``bn_prologue_triton.py`` (Triton): the BN-apply(+ReLU) prologue,
  counterpart of ``_make_prologue_kernel``.

Their wrappers, plain versions and launch counters are in
``ops/fused_bn_conv.py``.
"""
