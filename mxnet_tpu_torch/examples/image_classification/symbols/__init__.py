"""The example networks, against ``mxnet_tpu_torch.sym``. Import them as
``mxnet_tpu_torch.examples.image_classification.symbols.<name>``."""
