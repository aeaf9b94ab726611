"""Hand-written Hopper kernels of the port.

- ``csrc/bn_relu_conv1x1.cu`` (CUDA C++, ``sm_90a``): the fused
  BN-apply+ReLU+1x1-conv, counterpart of the TPU kernel
  ``_make_nchw_kernel``; built by ``build.py`` and bound with ``ctypes``.
- ``bn_prologue_triton.py`` (Triton): the BN-apply(+ReLU) prologue,
  counterpart of ``_make_prologue_kernel``.
- ``csrc/bn_relu_matmul.cu`` (CUDA C++, ``sm_90a``): the fused
  BN-apply+ReLU+matrix product of a row-major (M, K) x, counterpart of
  ``_make_kernel`` (``bn_relu_matmul``).
- ``bn_backward_triton.py`` (Triton): the BN backward's per-channel
  reduction and dx assembly, the kernels under the JAX package's
  analytic fused BN backwards.
- ``decode_attention_triton.py`` (Triton): D1, the masked decode /
  verify attention over the f32 or int8 KV-cache of decode serving
  (jnp in the JAX package, ``serving/decode/model.py``).

Their wrappers, plain versions and launch counters are in
``ops/fused_bn_conv.py`` (D1's in ``ops/decode_attention.py``).
"""
