"""Train CIFAR-10 (the port's copy of
``examples/image_classification/train_cifar10.py``; reference:
example/image-classification/train_cifar10.py).

    # synthetic benchmark mode (no dataset needed)
    python -m mxnet_tpu_torch.examples.image_classification.train_cifar10 \\
        --benchmark 1

RecordIO data (``--data-train``) needs ``ImageRecordIter`` (ROADMAP.md
A9) and raises until then.
"""
import argparse
import importlib
import logging

from .common import data, fit


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train cifar10",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_aug_args(parser)
    parser.set_defaults(
        network="resnet", num_layers=110,
        num_classes=10, num_examples=50000,
        image_shape="3,32,32",
        batch_size=128, num_epochs=300,
        lr=0.05, lr_step_epochs="200,250", wd=1e-4)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    net = importlib.import_module(
        f"{__package__}.symbols.{args.network}").get_symbol(
        num_classes=args.num_classes, num_layers=args.num_layers,
        image_shape=args.image_shape)

    return fit.fit(args, net, data.get_rec_iter)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
