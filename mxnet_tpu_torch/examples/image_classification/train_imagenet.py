"""Train ImageNet-scale image classification (the port's copy of
``examples/image_classification/train_imagenet.py``; reference:
example/image-classification/train_imagenet.py:58).

    # synthetic benchmark mode (no dataset needed)
    python -m mxnet_tpu_torch.examples.image_classification.train_imagenet \\
        --network resnet --num-layers 50 --benchmark 1 --dtype bfloat16

RecordIO data (``--data-train``) needs ``ImageRecordIter`` (ROADMAP.md
A9) and raises until then.
"""
import argparse
import importlib
import logging

from .common import data, fit


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_aug_args(parser)
    parser.set_defaults(
        network="resnet", num_layers=50,
        num_classes=1000, num_examples=1281167,
        image_shape="3,224,224",
        batch_size=128, num_epochs=80,
        lr=0.1, lr_step_epochs="30,60,80", wd=1e-4)
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
