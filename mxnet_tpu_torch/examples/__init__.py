"""Examples of the port, run as modules (``python -m
mxnet_tpu_torch.examples.<name>``)."""
