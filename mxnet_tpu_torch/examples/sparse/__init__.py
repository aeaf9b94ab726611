"""Sparse-embedding examples (``python -m
mxnet_tpu_torch.examples.sparse.two_tower``)."""
