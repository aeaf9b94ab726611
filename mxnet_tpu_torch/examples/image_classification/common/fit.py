"""The image-classification examples' training entry point, argparse to
``Module.fit`` (the port's copy of
``examples/image_classification/common/fit.py``; reference:
example/image-classification/common/fit.py:141).

``fit`` wires the kvstore (``kvstore.create(--kv-store)``), the lr
schedule, the Xavier initializer, checkpoints (``--model-prefix`` /
``--load-epoch``), a ``Speedometer`` and ``--monitor`` around
``Module.fit``; ``--benchmark 1`` runs ``_benchmark``, a timed loop of
the captured fused step on one batch set that prints one JSON line.

Device: ``--device`` names it (``cpu`` for a run without a card);
otherwise ``--gpus`` None, ``""`` or ``0`` is ``cuda:0``, where the
reference would take the CPU, and several GPUs raise (the device mesh is
ROADMAP.md A11). The data loader runs inside the device's context, so
synthetic batches are made on it.

``--dtype bfloat16`` differs between the two paths, as in the JAX
package: ``_benchmark`` builds the Module with ``compute_dtype=
"bfloat16"`` (bf16 compute, fp32 masters), while ``fit`` only sets
``multi_precision`` on the optimizer and computes in fp32.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

import mxnet_tpu_torch as mx


def add_fit_args(parser: argparse.ArgumentParser):
    """(reference: common/fit.py:58 add_fit_args)"""
    train = parser.add_argument_group("Training", "model training")
    train.add_argument("--network", type=str, help="the neural network to use")
    train.add_argument("--num-layers", type=int,
                       help="number of layers in the neural network")
    train.add_argument("--gpus", type=str, default=None,
                       help="GPUs to run on, e.g. '0'; one card only")
    train.add_argument("--device", type=str, default=None,
                       help="device to run on (e.g. 'cpu' or 'cuda:0'); "
                       "overrides --gpus")
    train.add_argument("--kv-store", type=str, default="device",
                       help="key-value store type")
    train.add_argument("--num-epochs", type=int, default=100)
    train.add_argument("--lr", type=float, default=0.1)
    train.add_argument("--lr-factor", type=float, default=0.1,
                       help="reduce the lr by this factor at each step")
    train.add_argument("--lr-step-epochs", type=str, default="30,60",
                       help="epochs at which the lr decays")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--batch-size", type=int, default=128)
    train.add_argument("--disp-batches", type=int, default=20,
                       help="show progress every N batches")
    train.add_argument("--model-prefix", type=str,
                       help="checkpoint prefix (save + resume)")
    train.add_argument("--load-epoch", type=int,
                       help="load the model saved at this epoch")
    train.add_argument("--top-k", type=int, default=0,
                       help="also report top-k accuracy")
    train.add_argument("--dtype", type=str, default="float32",
                       help="compute precision: float32 or bfloat16")
    train.add_argument("--monitor", type=int, default=0,
                       help="log network statistics every N batches")
    train.add_argument("--test-io", type=int, default=0,
                       help="only test the data pipeline speed")
    return train


def _device(args):
    """The run's device: ``--device``, else ``--gpus`` (None, "" or one
    id; several raise)."""
    if getattr(args, "device", None):
        return mx.context.as_context(args.device)
    gpus = [g for g in (args.gpus or "").split(",") if g.strip()]
    if len(gpus) > 1:
        raise NotImplementedError(
            f"--gpus {args.gpus}: training on several cards (the device "
            "mesh) is not ported (ROADMAP.md A11)")
    return mx.gpu(int(gpus[0]) if gpus else 0)


def _get_lr_scheduler(args, kv, epoch_size):
    """(reference: common/fit.py:30 _get_lr_scheduler)"""
    if not args.lr_factor or args.lr_factor >= 1:
        return args.lr, None
    begin_epoch = args.load_epoch or 0
    step_epochs = [int(s) for s in args.lr_step_epochs.split(",") if s]
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    if lr != args.lr:
        logging.info("Adjust learning rate to %e for epoch %d", lr,
                     begin_epoch)
    steps = [epoch_size * (x - begin_epoch) for x in step_epochs
             if x - begin_epoch > 0]
    if not steps:
        return lr, None
    return lr, mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                    factor=args.lr_factor)


def _load_model(args, rank=0):
    if args.load_epoch is None or args.model_prefix is None:
        return None, None, None
    sym, arg_params, aux_params = mx.model.load_checkpoint(
        args.model_prefix, args.load_epoch)
    logging.info("Loaded model %s_%04d.params", args.model_prefix,
                 args.load_epoch)
    return sym, arg_params, aux_params


def _save_model(args, rank=0):
    if args.model_prefix is None:
        return None
    dst_dir = os.path.dirname(args.model_prefix)
    if dst_dir and not os.path.isdir(dst_dir):
        os.makedirs(dst_dir, exist_ok=True)
    return mx.callback.do_checkpoint(
        args.model_prefix if rank == 0
        else "%s-%d" % (args.model_prefix, rank))


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _benchmark(args, network, train):
    """A timed steady-state loop of the fused step (``Module(fused=
    True)``): three warm-up steps (eager, the capture, a replay), then
    three runs of ``benchmark_steps`` steps over the first four batches,
    the best run kept. One sync ends each run; the card's time of the
    runs (CUDA events) is kept beside the host clock's in
    ``model.benchmark_result``. Prints the JAX example's JSON line
    (``vs_baseline`` null: no number of another machine is quoted)."""
    ctx = _device(args)
    compute_dtype = "bfloat16" if args.dtype == "bfloat16" else None
    model = mx.mod.Module(context=ctx, symbol=network, fused=True,
                          compute_dtype=compute_dtype)
    model.bind(train.provide_data, train.provide_label)
    model.init_params(mx.init.Xavier(rnd_type="gaussian",
                                     factor_type="in", magnitude=2))
    optimizer_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer in ("sgd", "nag", "signum", "lbsgd"):
        optimizer_params["momentum"] = args.mom
    model.init_optimizer(kvstore=None, optimizer=args.optimizer,
                         optimizer_params=optimizer_params)
    assert model._fused is not None

    batches = []
    for batch in train:
        batches.append(batch)
        if len(batches) >= 4:
            break
    train.reset()

    steps = getattr(args, "benchmark_steps", 30)
    for _ in range(3):
        model.forward(batches[0], is_train=True)
        model.backward()
        model.update()
    _sync(ctx)

    cuda = ctx.device.type == "cuda"
    best, best_dev = float("inf"), None
    for _ in range(3):
        if cuda:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        t0 = time.perf_counter()
        for i in range(steps):
            model.forward(batches[i % len(batches)], is_train=True)
            model.backward()
            model.update()
        if cuda:
            ev1.record()
        _sync(ctx)
        dt = time.perf_counter() - t0
        if dt < best:
            best = dt
            best_dev = ev0.elapsed_time(ev1) / 1e3 if cuda else None
    img_s = args.batch_size * steps / best
    line = {
        "metric": "module_fit_train_throughput",
        "value": round(img_s, 2),
        "unit": "images/sec",
        "vs_baseline": None,
        "network": args.network,
        "batch": args.batch_size,
        "steps": steps,
        "step_time_s": round(best / steps, 5),
        "path": "Module(fused) symbolic graph + functional optimizer "
                f"[{args.optimizer}, dtype={args.dtype}]",
    }
    print(json.dumps(line), flush=True)
    model.benchmark_result = dict(
        line, host_s=best, device_s=best_dev, device=str(ctx.device))
    return model


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` (a Symbol) on the iterators of ``data_loader``
    (reference: common/fit.py:141); ``kwargs`` go to ``Module.fit``
    (``arg_params`` / ``aux_params`` warm-start it)."""
    ctx = _device(args)
    with ctx:
        if getattr(args, "benchmark", 0):
            train, _ = data_loader(args, None)
            return _benchmark(args, network, train)
        return _fit(args, network, data_loader, ctx, **kwargs)


def _fit(args, network, data_loader, ctx, **kwargs):
    kv = mx.kvstore.create(args.kv_store)

    head = "%(asctime)-15s Node[" + str(kv.rank) + "] %(message)s"
    logging.basicConfig(level=logging.INFO, format=head)
    logging.info("start with arguments %s", args)

    train, val = data_loader(args, kv)

    if args.test_io:
        tic = time.time()
        for i, batch in enumerate(train):
            for j in batch.data:
                j.wait_to_read()
            if (i + 1) % args.disp_batches == 0:
                logging.info("Batch [%d]\tSpeed: %.2f samples/sec", i,
                             args.disp_batches * args.batch_size /
                             (time.time() - tic))
                tic = time.time()
        return None

    sym, arg_params, aux_params = _load_model(args, kv.rank)
    if sym is not None:
        assert sym.tojson() == network.tojson()
    # caller-provided warm-start params (fine_tune.py) take precedence
    # over checkpoint loading; both cannot be active at once
    caller_arg = kwargs.pop("arg_params", None)
    caller_aux = kwargs.pop("aux_params", None)
    if caller_arg is not None or caller_aux is not None:
        assert arg_params is None and aux_params is None, \
            "pass either --load-epoch or explicit arg/aux_params, not both"
        arg_params, aux_params = caller_arg, caller_aux

    checkpoint = _save_model(args, kv.rank)

    epoch_size = args.num_examples // args.batch_size
    lr, lr_scheduler = _get_lr_scheduler(args, kv, epoch_size)

    model = mx.mod.Module(context=ctx, symbol=network)

    optimizer_params = {
        "learning_rate": lr,
        "wd": args.wd,
        "lr_scheduler": lr_scheduler}
    if args.optimizer in ("sgd", "nag", "signum", "lbsgd"):
        optimizer_params["momentum"] = args.mom
    # fp32 master weights for a bf16 run; on this path the Module
    # computes in fp32 all the same (only _benchmark sets compute_dtype)
    if args.dtype == "bfloat16":
        optimizer_params["multi_precision"] = True

    initializer = mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)

    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(mx.metric.create("top_k_accuracy",
                                             top_k=args.top_k))

    batch_end_callbacks = [mx.callback.Speedometer(args.batch_size,
                                                   args.disp_batches)]

    monitor = mx.mon.Monitor(args.monitor, pattern=".*") \
        if args.monitor > 0 else None

    model.fit(train,
              begin_epoch=args.load_epoch if args.load_epoch else 0,
              num_epoch=args.num_epochs,
              eval_data=val,
              eval_metric=eval_metrics,
              kvstore=kv,
              optimizer=args.optimizer,
              optimizer_params=optimizer_params,
              initializer=initializer,
              arg_params=arg_params,
              aux_params=aux_params,
              batch_end_callback=batch_end_callbacks,
              epoch_end_callback=checkpoint,
              allow_missing=True,
              monitor=monitor,
              **kwargs)
    return model
