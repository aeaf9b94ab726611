"""Train an MLP or LeNet on MNIST (the port's copy of
``examples/image_classification/train_mnist.py``; reference:
example/image-classification/train_mnist.py).

    python -m mxnet_tpu_torch.examples.image_classification.train_mnist
    python -m mxnet_tpu_torch.examples.image_classification.train_mnist \\
        --network lenet --num-epochs 5 --device cpu

Without the MNIST idx files under --data-dir the script trains on a
learnable synthetic set of the same shape (nothing is downloaded).
"""
import argparse
import importlib
import logging

from .common import data, fit


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train mnist",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--num-examples", type=int, default=60000)
    parser.add_argument("--add_stn", action="store_true")
    parser.add_argument("--data-dir", type=str, default="data/mnist")
    fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", num_epochs=10,
                        lr=0.05, lr_step_epochs="10", batch_size=64,
                        disp_batches=100)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    net = importlib.import_module(
        f"{__package__}.symbols.{args.network}").get_symbol(
        num_classes=args.num_classes)

    return fit.fit(args, net, data.get_mnist_iter)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
