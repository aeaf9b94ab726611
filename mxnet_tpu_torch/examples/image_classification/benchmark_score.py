"""Inference throughput of the example networks (the port's copy of
``examples/image_classification/benchmark_score.py``; reference:
example/image-classification/benchmark_score.py).

Each network is bound for inference in a ``Module`` on ``--device``
(``cuda:0`` by default), initialized with Xavier, and scored on four
random batches in ``--dtype`` that lie on the device; forwards run the
executor's captured eval program back to back, each output summed into
one device scalar, with one sync at the end of a run (the best of three
runs is kept).

What a ``bfloat16`` batch computes, as in the JAX package: the batch
stays bf16 (the executor's data array takes the batch's dtype), every
convolution runs in its input's dtype with the float32 weight cast to
it, BatchNorm keeps bf16, a float32 bias added to a bf16 result
promotes it to float32, and FullyConnected computes in float32 (bf16
data, float32 weight). So the BatchNorm networks (inception-bn,
inception-v3, mobilenet, resnet, resnext) run in bf16 up to the
classifier, and the networks whose convolutions carry a bias (alexnet,
googlenet, vgg) run their first convolution in bf16 and the rest in
float32.

    python -m mxnet_tpu_torch.examples.image_classification.benchmark_score \\
        --networks resnet-50,inception-v3 --batch-sizes 32

Prints one JSON line per (network, batch).
"""
import argparse
import json
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.dtype import resolve_dtype

from .symbols import alexnet as _alexnet
from .symbols import googlenet as _googlenet
from .symbols import inception_bn as _incbn
from .symbols import inception_v3 as _inc3
from .symbols import mobilenet as _mobilenet
from .symbols import resnet as _resnet
from .symbols import resnext as _resnext
from .symbols import vgg as _vgg


def get_network(name):
    """Returns (symbol, image_shape)."""
    if name == "alexnet":
        return _alexnet.get_symbol(1000), (3, 224, 224)
    if name == "googlenet":
        return _googlenet.get_symbol(1000), (3, 224, 224)
    if name == "inception-bn":
        return _incbn.get_symbol(1000), (3, 224, 224)
    if name == "mobilenet":
        return _mobilenet.get_symbol(1000), (3, 224, 224)
    if name.startswith("vgg-"):
        parts = name.split("-")
        if len(parts) == 2 and parts[1].isdigit():
            return _vgg.get_symbol(1000, int(parts[1])), (3, 224, 224)
        if len(parts) == 3 and parts[1].isdigit() and parts[2] == "bn":
            return _vgg.get_symbol(1000, int(parts[1]),
                                   batch_norm=True), (3, 224, 224)
        raise ValueError(f"unknown network {name}")
    if name == "inception-v3":
        return _inc3.get_symbol(1000), (3, 299, 299)
    if name.startswith("resnext-"):
        return _resnext.get_symbol(
            1000, int(name.split("-")[1])), (3, 224, 224)
    if name.startswith("resnet-"):
        num_layers = int(name.split("-")[1])
        return _resnet.get_symbol(1000, num_layers, "3,224,224"), \
            (3, 224, 224)
    raise ValueError(f"unknown network {name}")


def bind_scoring(network, batch, dtype="bfloat16", device=None):
    """(module, batches): ``network`` bound for inference at ``batch``
    on ``device``, Xavier-initialized, and four random batches of
    ``dtype`` on the device (numpy's draws from seed 0, rounded by
    torch)."""
    sym, image_shape = get_network(network)
    ctx = mx.context.as_context(device)
    mod = mx.mod.Module(symbol=sym, context=ctx,
                        label_names=("softmax_label",))
    data_shape = (batch,) + image_shape
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (batch,))],
             for_training=False)
    mod.init_params(mx.init.Xavier())
    rng = np.random.RandomState(0)
    batches = [
        mx.io.DataBatch([mx.nd.array(torch.from_numpy(
            rng.rand(*data_shape).astype(np.float32)).to(
            resolve_dtype(dtype)), ctx=ctx)], [])
        for _ in range(4)
    ]
    return mod, batches


def time_scoring(mod, batches, steps=30):
    """Seconds of the best of three runs of ``steps`` forwards, after
    two warm-up forwards (the eager one and the capture) and a read."""
    for b in batches[:2]:
        mod.forward(b, is_train=False)
    mod.get_outputs()[0].asnumpy()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = None
        for i in range(steps):
            mod.forward(batches[i % 4], is_train=False)
            # chain every output into one device scalar: the final wait
            # covers all forwards, with no read between them
            s = mod.get_outputs()[0].sum()
            acc = s if acc is None else acc + s
        acc.wait_to_read()
        best = min(best, time.perf_counter() - t0)
    return best


def score(network, batch, dtype="bfloat16", steps=30, device=None):
    """Prints and returns ``network``'s img/s at ``batch``."""
    mod, batches = bind_scoring(network, batch, dtype, device)
    best = time_scoring(mod, batches, steps)
    img_s = batch * steps / best
    print(json.dumps({"network": network, "batch": batch,
                      "dtype": dtype, "img_s": round(img_s, 1),
                      "ms_per_batch": round(1000 * best / steps, 3)}),
          flush=True)
    return img_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--networks", type=str,
                    default="alexnet,resnet-50,resnet-152,inception-v3")
    ap.add_argument("--batch-sizes", type=str, default="32,128")
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", type=str, default="cuda:0")
    args = ap.parse_args(argv)
    return {(net, int(b)): score(net, int(b), args.dtype, args.steps,
                                 args.device)
            for net in args.networks.split(",")
            for b in args.batch_sizes.split(",")}


if __name__ == "__main__":
    main()
