"""DLRM-style two-tower recommender on SparseEmbedding (the port's
counterpart of ``examples/sparse/two_tower.py``).

Each tower is a ``SparseEmbedding`` table (users, items) whose gradient
takes the fused step's row-sparse path: only the rows a batch touched
are gathered, deduplicated and lazily updated (``sparse/``, the lazy
rules of ``parallel/functional_opt.py``). The towers concatenate into a
small MLP and a binary click head.

The script runs the slice end to end:

- training through ``fit()`` over a ``DataPipeline`` around the host
  iterator, with a ``CheckpointManager`` saving the tables and the lazy
  optimizer state every epoch (rerun with the same ``--workdir``:
  ``auto_resume`` continues after the last saved epoch);
- ``sparse_report()`` after training (touched rows, dedup ratio, gather
  and scatter bytes);
- serving integer ids through ``Predictor`` and ``DynamicBatcher``.

Everything runs on ``--device`` (``cuda:0`` by default, ``cpu`` for a
run without a card).

Run: python -m mxnet_tpu_torch.examples.sparse.two_tower
     python -m mxnet_tpu_torch.examples.sparse.two_tower --mini --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.data.pipeline import DataPipeline


def build_sym(n_users, n_items, embed_dim, hidden):
    user = mx.sym.Variable("user")
    item = mx.sym.Variable("item")
    u = mx.sym.SparseEmbedding(data=user, input_dim=n_users,
                               output_dim=embed_dim, name="user_emb")
    i = mx.sym.SparseEmbedding(data=item, input_dim=n_items,
                               output_dim=embed_dim, name="item_emb")
    x = mx.sym.Concat(mx.sym.Flatten(u), mx.sym.Flatten(i), dim=1)
    h = mx.sym.FullyConnected(x, num_hidden=hidden, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    o = mx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(o, name="softmax")


def make_synthetic(n_users, n_items, num_rows, embed_dim=4, seed=0):
    """Clicks from a planted low-rank affinity: label = [u_vec . i_vec >
    0] for random per-id vectors, learnable by this model."""
    rng = np.random.RandomState(seed)
    uvec = rng.randn(n_users, embed_dim).astype(np.float32)
    ivec = rng.randn(n_items, embed_dim).astype(np.float32)
    users = rng.randint(0, n_users, size=(num_rows, 1)).astype(np.int32)
    items = rng.randint(0, n_items, size=(num_rows, 1)).astype(np.int32)
    score = (uvec[users[:, 0]] * ivec[items[:, 0]]).sum(axis=1)
    label = (score > 0).astype(np.float32)
    return users, items, label


def train(workdir, n_users=200, n_items=100, embed_dim=8, hidden=16,
          num_rows=2048, batch_size=64, num_epoch=3, pipeline_workers=2,
          quiet=False, device="cuda:0"):
    users, items, label = make_synthetic(n_users, n_items, num_rows)
    base_iter = mx.io.NDArrayIter(
        data={"user": users, "item": items}, label={"softmax_label": label},
        batch_size=batch_size, shuffle=False)
    train_iter = DataPipeline(base_iter, num_workers=pipeline_workers,
                              sharding=device, name="two_tower")
    mod = mx.mod.Module(
        symbol=build_sym(n_users, n_items, embed_dim, hidden),
        data_names=("user", "item"), label_names=("softmax_label",),
        context=device)
    manager = mx.CheckpointManager(os.path.join(workdir, "ckpt"))
    try:
        mod.fit(train_iter, num_epoch=num_epoch, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                initializer=mx.init.Xavier(), eval_metric="acc",
                checkpoint_manager=manager, auto_resume=True,
                batch_end_callback=None if quiet else
                mx.callback.Speedometer(batch_size, 16))
    finally:
        train_iter.close()
    base_iter.reset()
    acc = mod.score(base_iter, "acc")[0][1]
    return mod, acc


def serve(mod, n_requests=32, seed=1, device="cuda:0"):
    """Integer ids through Predictor buckets, and the same requests in
    few-row pieces through the DynamicBatcher."""
    arg_params, aux_params = mod.get_params()
    pred = mx.serving.Predictor(
        mod.symbol, arg_params, aux_params,
        data_names=("user", "item"),
        data_shapes={"user": (1,), "item": (1,)}, buckets=(8, 32),
        device=device)
    rng = np.random.RandomState(seed)
    req = {"user": rng.randint(0, 10, size=(n_requests, 1), dtype=np.int32),
           "item": rng.randint(0, 10, size=(n_requests, 1), dtype=np.int32)}
    direct = pred.predict(req)
    batcher = mx.serving.DynamicBatcher(pred, name="two_tower").start()
    try:
        futs = [batcher.submit({k: v[i:i + 4] for k, v in req.items()})
                for i in range(0, n_requests, 4)]
        batched = np.concatenate([f.result() for f in futs], axis=0)
    finally:
        batcher.stop()
    np.testing.assert_allclose(direct, batched, rtol=1e-5, atol=1e-6)
    return direct


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mini", action="store_true",
                    help="the small run (tiny vocab, 1 epoch)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one; pass the same one twice to resume)")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="two_tower_")
    kw = dict(workdir=workdir, device=args.device)
    if args.mini:
        kw.update(n_users=40, n_items=24, embed_dim=4, hidden=8,
                  num_rows=256, batch_size=32, num_epoch=1,
                  pipeline_workers=1, quiet=True)
    mod, acc = train(**kw)
    scores = serve(mod, n_requests=16 if args.mini else 64,
                   device=args.device)
    report = mx.sparse.sparse_report()
    print(f"train acc: {acc:.3f}  serving rows: {scores.shape[0]}")
    print("sparse_report:", report)
    return {"acc": acc, "scores": scores, "sparse": report, "module": mod}


if __name__ == "__main__":
    main()
