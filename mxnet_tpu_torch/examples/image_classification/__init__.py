"""The image-classification examples on the port (counterparts of
``examples/image_classification/``): ``train_mnist``,
``train_imagenet``, ``train_cifar10``, ``fine_tune``, ``score`` and
``benchmark_score``, each run as ``python -m
mxnet_tpu_torch.examples.image_classification.<script>``, with the
networks of ``symbols`` and the training code of ``common``."""
