"""Score a trained checkpoint on a validation set (the port's copy of
``examples/image_classification/score.py``; reference:
example/image-classification/score.py).

Its validation data is RecordIO through ``ImageRecordIter``, which is
not ported (ROADMAP.md A9): until then ``score`` raises.

    python -m mxnet_tpu_torch.examples.image_classification.score \\
        --model-prefix ckpt/r50 --load-epoch 90 --data-val val.rec
"""
import argparse


def score(model_prefix, load_epoch, data_val, image_shape=(3, 224, 224),
          batch_size=128, rgb_mean=(123.68, 116.779, 103.939),
          metrics=("acc",), data_nthreads=4, max_num_batches=None):
    """The reference's scoring of a checkpoint over a RecordIO file."""
    raise NotImplementedError(
        "score reads its validation set through ImageRecordIter, which is "
        "not ported (ROADMAP.md A9)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-prefix", required=True)
    ap.add_argument("--load-epoch", type=int, required=True)
    ap.add_argument("--data-val", required=True)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--metrics", default="acc")
    ap.add_argument("--data-nthreads", type=int, default=4)
    ap.add_argument("--max-num-batches", type=int, default=None)
    args = ap.parse_args(argv)
    res = score(args.model_prefix, args.load_epoch, args.data_val,
                tuple(int(x) for x in args.image_shape.split(",")),
                args.batch_size, metrics=args.metrics.split(","),
                data_nthreads=args.data_nthreads,
                max_num_batches=args.max_num_batches)
    for name, value in res:
        print(name, value)
    return res


if __name__ == "__main__":
    main()
