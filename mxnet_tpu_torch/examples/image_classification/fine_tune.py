"""Fine-tune a checkpoint on a new dataset (the port's copy of
``examples/image_classification/fine_tune.py``; reference:
example/image-classification/fine-tune.py).

Replaces the classifier head (everything after --layer-before-fullc)
with a fresh FC for the new class count, then trains with
``common/fit.py``; the backbone weights come from the checkpoint (either package's
files).

    python -m mxnet_tpu_torch.examples.image_classification.fine_tune \\
        --pretrained-model ckpt/r50 --load-epoch 90 --benchmark 1 \\
        --num-classes 256
"""
import argparse
import logging

import mxnet_tpu_torch as mx

from .common import data, fit


def get_fine_tune_model(symbol, arg_params, num_classes,
                        layer_name="flatten0"):
    """Cut the graph after ``layer_name`` and attach a fresh classifier
    (reference: fine-tune.py get_fine_tune_model)."""
    all_layers = symbol.get_internals()
    net = all_layers[layer_name + "_output"]
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc_new")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    # keep only the params the cut graph still uses: the old head goes,
    # and a wrong --layer-before-fullc fails here instead of carrying
    # orphaned weights
    keep = set(net.list_arguments())
    new_args = {k: v for k, v in arg_params.items()
                if k in keep and not k.startswith("fc_new")}
    if not new_args:
        raise ValueError(
            f"no checkpoint params survive the cut at {layer_name!r}; "
            "check --layer-before-fullc")
    return net, new_args


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="fine-tune a pretrained model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_aug_args(parser)
    parser.add_argument("--pretrained-model", required=True,
                        help="checkpoint prefix to start from")
    parser.add_argument("--layer-before-fullc", default="flatten0",
                        help="name of the layer before the classifier")
    parser.set_defaults(
        network=None, image_shape="3,224,224", num_epochs=30,
        lr=0.01, lr_step_epochs="20", wd=1e-4, batch_size=128)
    args = parser.parse_args(argv)

    sym, arg_params, aux_params = mx.model.load_checkpoint(
        args.pretrained_model, args.load_epoch or 0)
    net, new_args = get_fine_tune_model(
        sym, arg_params, args.num_classes, args.layer_before_fullc)
    # fit must not reload the checkpoint on top of the edited graph
    args.load_epoch = None
    return fit.fit(args, net, data.get_rec_iter,
                   arg_params=new_args, aux_params=aux_params)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
