"""The SSD example (``mxnet_tpu_torch/examples/ssd/train.py``) against the
JAX package's (``examples/ssd/train.py``), on the CPU: with the JAX
TinySSD's weights loaded into the port's (``interop.gluon_params_from_
jax``), one training batch's forward (class and box predictions,
anchors), its MultiBoxTarget targets, the three losses and every
parameter's gradient agree at rtol 1e-4 (atol 1e-5 for values about 0;
the targets' classes and masks exactly); and the port's ``train(2
epochs x 40 steps)`` reaches the JAX test's own thresholds
(``tests/test_ssd_ops.py``: mean IoU > 0.5, class accuracy > 0.8)."""
import importlib.util
import pathlib

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples.ssd import train as pt

TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_example():
    path = (pathlib.Path(__file__).parent.parent / "examples" / "ssd"
            / "train.py")
    spec = importlib.util.spec_from_file_location("jax_ssd_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step(mx, ex, net, imgs, labels):
    """Forward, targets, losses and backward of one batch, as numpy."""
    with mx.autograd.record():
        cls_pred, loc_pred, anchor = net(imgs)
        loc_t, loc_m, cls_t = mx.nd.MultiBoxTarget(
            anchor, labels, cls_pred.transpose((0, 2, 1)),
            overlap_threshold=0.5, negative_mining_ratio=3.0,
            negative_mining_thresh=0.5)
        losses = ex.ssd_losses(cls_pred, loc_pred, cls_t, loc_t, loc_m)
    losses[0].backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()
             if p.grad_req != "null"]
    return ([t.asnumpy() for t in (cls_pred, loc_pred, anchor)],
            [t.asnumpy() for t in (loc_t, loc_m, cls_t)],
            [float(v.asscalar()) for v in losses], grads)


def test_one_batch_matches_jax():
    import mxnet_tpu as mx
    jex = _jax_example()
    batch = jex.make_batch(8, np.random.RandomState(7))
    imgs, labels = (a.asnumpy() for a in batch)

    mx.random.seed(0)
    jnet = jex.TinySSD()
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(imgs))                  # finish the deferred init
    jparams = list(jnet.collect_params().items())
    want = _step(mx, jex, jnet, mx.nd.array(imgs), mx.nd.array(labels))

    with mt.cpu():
        pnet = pt.TinySSD()
        pnet.initialize(mt.init.Xavier(), ctx=mt.cpu())
        pnet(mt.nd.array(imgs, ctx=mt.cpu()))
        pnames = list(pnet.collect_params().keys())
        assert [n.split("_", 1)[1] for n in pnames] == \
            [n.split("_", 1)[1] for n, _ in jparams]
        mt.interop.gluon_params_from_jax(
            {p: v.data().asnumpy() for p, (_, v) in zip(pnames, jparams)},
            pnet, "cpu")
        got = _step(mt, pt, pnet, mt.nd.array(imgs, ctx=mt.cpu()),
                    mt.nd.array(labels, ctx=mt.cpu()))

    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[1][0], want[1][0], **TOL)
    for k in (1, 2):                          # mask and classes
        np.testing.assert_array_equal(got[1][k], want[1][k])
    np.testing.assert_allclose(got[2], want[2], **TOL)
    assert len(got[3]) == len(want[3])
    for name, g, w in zip(pnames, got[3], want[3]):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_port_example_converges():
    iou, acc = pt.train(num_epoch=2, steps_per_epoch=40,
                        log=lambda *a: None, device="cpu")
    assert iou > 0.5, f"SSD mean IoU {iou}"
    assert acc > 0.8, f"SSD class accuracy {acc}"
