"""The Gluon layers and ops of slice 17 (``mxnet_tpu_torch.gluon.nn``,
``ops/nn.py``, ``ops/shape_ops.py``) against the JAX package's, on the
CPU.

- Every new layer: built in both packages under one prefix, the JAX
  package's parameters set from seeded numpy draws and carried by name
  (``interop.gluon_params_from_jax``), the same input through both.
  Forwards within 1e-5 (fp32; read: a few 1e-7).
- The same layers with ``F = sym``: the port's graph of the layer
  evaluated on the same parameters gives its NDArray forward (1e-5), and
  its JSON equals the JAX package's, except for the layers on the
  ``LeakyReLU`` op: the JAX package's symbol adds a ``gamma`` argument to
  every act_type, where the reference (``leaky_relu-inl.h``) and the port
  add it for ``prelu`` alone (ROADMAP.md queue C).
- Every new op and attribute combination (Deconvolution with groups and
  ``adj``, 1-D and 3-D Convolution and Pooling in every convention,
  ``LeakyReLU`` in every act_type, ``InstanceNorm``, ``Pad`` in its three
  modes) through ``nd``: forward within 1e-5, and the gradient of
  ``sum(out * w)`` for a seeded ``w`` with respect to every input within
  1e-4 relative L2 (read: ~1e-7). A max pool's window that lies wholly in
  the padding gives -inf in both. ``Deconvolution``'s ``target_shape``,
  which the JAX op ignores, is held against the reference's rule.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.name import NameManager as JaxNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.name import NameManager as TorchNameManager
from torch_threads import one_torch_thread  # noqa: F401

FWD_ATOL = 1e-5
GRAD_REL_L2 = 1e-4


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _concurrent(nn, cls):
    net = getattr(nn, cls)(axis=1, prefix="cc_")
    with net.name_scope():
        net.add(nn.Dense(4), nn.Dense(3), nn.Identity())
    return net


# (name, factory of the layer from a package's ``gluon.nn``, input shape)
LAYERS = [
    ("LeakyReLU", lambda nn: nn.LeakyReLU(0.1), (2, 3, 5, 5)),
    ("PReLU", lambda nn: nn.PReLU(), (2, 3, 5, 5)),
    ("ELU", lambda nn: nn.ELU(0.7), (2, 3, 5, 5)),
    ("SELU", lambda nn: nn.SELU(), (2, 3, 5, 5)),
    ("Swish", lambda nn: nn.Swish(1.5), (2, 3, 5, 5)),
    ("InstanceNorm", lambda nn: nn.InstanceNorm(scale=True), (2, 3, 5, 6)),
    ("LayerNorm", lambda nn: nn.LayerNorm(), (2, 5, 6)),
    ("HybridConcurrent", lambda nn: _concurrent(nn, "HybridConcurrent"),
     (2, 5)),
    ("Concurrent", lambda nn: _concurrent(nn, "Concurrent"), (2, 5)),
    ("Identity", lambda nn: nn.Identity(), (2, 3)),
    ("HybridLambda", lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), (2, 3)),
    ("Lambda", lambda nn: nn.Lambda("tanh"), (2, 3)),
    ("Conv1D", lambda nn: nn.Conv1D(4, 3, padding=1, dilation=2), (2, 3, 9)),
    ("Conv3D", lambda nn: nn.Conv3D(4, 3, strides=2, padding=1),
     (2, 3, 5, 6, 7)),
    ("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 3, 9)),
    ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(4, 4, 2, 1),
     (2, 3, 5, 6)),
    ("Conv2DTranspose_groups", lambda nn: nn.Conv2DTranspose(
        4, 3, 2, 1, output_padding=(1, 0), groups=2, use_bias=False),
     (2, 4, 5, 6)),
    ("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(
        4, 3, strides=2, padding=1), (2, 3, 3, 4, 5)),
    ("MaxPool1D", lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 9)),
    ("MaxPool3D", lambda nn: nn.MaxPool3D(2), (2, 3, 4, 6, 5)),
    ("AvgPool1D", lambda nn: nn.AvgPool1D(3, 2, 1, count_include_pad=False),
     (2, 3, 9)),
    ("AvgPool3D", lambda nn: nn.AvgPool3D(2, ceil_mode=True),
     (2, 3, 5, 6, 7)),
    ("GlobalMaxPool1D", lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9)),
    ("GlobalMaxPool2D", lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
    ("GlobalMaxPool3D", lambda nn: nn.GlobalMaxPool3D(), (2, 3, 4, 5, 6)),
    ("GlobalAvgPool1D", lambda nn: nn.GlobalAvgPool1D(), (2, 3, 9)),
    ("GlobalAvgPool3D", lambda nn: nn.GlobalAvgPool3D(), (2, 3, 4, 5, 6)),
    ("ReflectionPad2D", lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
]
# layers on the LeakyReLU op (their JAX symbol carries a stray gamma)
LEAKY_OP = {"LeakyReLU", "ELU", "SELU"}


def _pair(factory, shape, seed=0):
    """The layer in both packages with equal parameters, and an input."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    with JaxNameManager():
        jl = factory(jgluon.nn)
    with TorchNameManager():
        tl = factory(tgluon.nn)
    if list(jl.collect_params().keys()):
        jl.initialize(jmx.init.Xavier())
        jl(jnd.array(x))                  # finishes a deferred init
        rng = np.random.default_rng(seed + 1)
        for p in jl.collect_params().values():
            p.set_data(jnd.array(rng.uniform(
                0.5, 1.5, p.shape).astype(np.float32)))
        tmx.interop.gluon_params_from_jax(
            {n: p.data().asnumpy() for n, p in jl.collect_params().items()},
            tl, "cpu")
    return jl, tl, x


@pytest.mark.parametrize("name,factory,shape", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_forward_matches_jax(name, factory, shape):
    jl, tl, x = _pair(factory, shape)
    want = jl(jnd.array(x)).asnumpy()
    got = tl(tnd.array(x)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


SYMBOLIC = [c for c in LAYERS if c[0] != "Lambda"]


@pytest.mark.parametrize("name,factory,shape", SYMBOLIC,
                         ids=[c[0] for c in SYMBOLIC])
def test_layer_symbol_matches_forward_and_jax_json(name, factory, shape):
    jl, tl, x = _pair(factory, shape)
    with TorchNameManager():
        tsym = tl(tmx.sym.var("data"))
    arrays = {"data": torch.tensor(x)}
    arrays.update({n: p.data().data for n, p in
                   tl.collect_params().items()})
    got = tsym.eval_arrays(arrays)[0].detach().numpy()
    want = tl(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    with JaxNameManager():
        jsym = jl(jmx.sym.var("data"))
    extra = set(jsym.list_arguments()) - set(tsym.list_arguments())
    if name in LEAKY_OP:
        assert extra and all(a.endswith("_gamma") for a in extra)
        assert not any(a.endswith("_gamma") for a in tsym.list_arguments())
    else:
        assert tsym.tojson() == jsym.tojson()


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (op, input shapes, attributes)
OPS = [
    ("Convolution", [(2, 4, 9), (6, 2, 3)],
     dict(kernel=(3,), stride=(2,), pad=(1,), num_group=2, no_bias=True,
          num_filter=6)),
    ("Convolution", [(2, 3, 5, 6, 7), (4, 3, 3, 3, 3), (4,)],
     dict(kernel=(3, 3, 3), pad=(1, 1, 1), dilate=(1, 2, 1), num_filter=4)),
    ("Deconvolution", [(2, 4, 9), (4, 3, 3)],
     dict(kernel=(3,), stride=(2,), pad=(1,), adj=(1,), num_filter=3)),
    ("Deconvolution", [(2, 4, 5, 6), (4, 3, 4, 4), (6,)],
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_group=2,
          num_filter=6, no_bias=False)),
    ("Deconvolution", [(2, 4, 3, 4, 5), (4, 2, 3, 3, 3)],
     dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1),
          adj=(1, 0, 1), dilate=(1, 1, 2), num_filter=2)),
    ("Pooling", [(2, 3, 9)], dict(kernel=(3,), stride=(2,), pad=(1,),
                                  pool_type="max")),
    ("Pooling", [(2, 3, 9)], dict(kernel=(2,), stride=(2,), pad=(1,),
                                  pool_type="max",
                                  pooling_convention="full")),
    ("Pooling", [(2, 3, 9)], dict(kernel=(3,), stride=(2,), pad=(1,),
                                  pool_type="avg", count_include_pad=False,
                                  pooling_convention="full")),
    ("Pooling", [(2, 3, 9)], dict(kernel=(3,), stride=(2,), pool_type="sum")),
    ("Pooling", [(2, 3, 5, 6, 7)], dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                        pool_type="max",
                                        pooling_convention="full")),
    ("Pooling", [(2, 3, 5, 6, 7)], dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                        pad=(1, 1, 1), pool_type="avg")),
    ("Pooling", [(2, 3, 5, 6, 7)], dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                        pad=(1, 1, 1), pool_type="sum",
                                        pooling_convention="full")),
    ("Pooling", [(2, 3, 5, 6, 7)], dict(global_pool=True, pool_type="avg")),
    ("LeakyReLU", [(2, 3, 4, 5)], dict(act_type="leaky", slope=0.2)),
    ("LeakyReLU", [(2, 3, 4, 5)], dict(act_type="elu", slope=0.7)),
    ("LeakyReLU", [(2, 3, 4, 5), (3,)], dict(act_type="prelu")),
    ("LeakyReLU", [(2, 3, 4, 5)], dict(act_type="selu")),
    ("LeakyReLU", [(2, 3, 4, 5)], dict(act_type="rrelu")),
    ("InstanceNorm", [(2, 3, 4, 5), (3,), (3,)], dict(eps=1e-3)),
    ("Pad", [(2, 3, 4, 5)], dict(mode="constant", constant_value=0.5,
                                 pad_width=(0, 0, 1, 0, 1, 2, 2, 1))),
    ("Pad", [(2, 3, 4, 5)], dict(mode="edge",
                                 pad_width=(0, 0, 0, 0, 1, 2, 2, 1))),
    ("Pad", [(2, 3, 4, 5, 6)], dict(mode="reflect",
                                    pad_width=(0, 0, 0, 0, 1, 2, 2, 1, 1, 1))),
]


def _run(pkg_nd, ag, arrays, op, attrs, w):
    ins = [pkg_nd.array(a) for a in arrays]
    for a in ins:
        a.attach_grad()
    finite = pkg_nd.array(np.isfinite(w).astype(np.float32))
    with ag.record():
        out = getattr(pkg_nd, op)(*ins, **attrs)
        # the -inf of an all-padding window takes no part in the loss
        kept = pkg_nd.where(finite, out, pkg_nd.zeros_like(out))
        loss = (kept * pkg_nd.array(np.nan_to_num(w, posinf=0, neginf=0))
                ).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in ins]


@pytest.mark.parametrize("op,shapes,attrs", OPS,
                         ids=[f"{o}-{i}" for i, (o, _, _) in enumerate(OPS)])
def test_op_forward_and_gradients_match_jax(op, shapes, attrs):
    arrays = [_w(s, i) for i, s in enumerate(shapes)]
    want_out = getattr(jnd, op)(*[jnd.array(a) for a in arrays],
                                **attrs).asnumpy()
    w = np.where(np.isfinite(want_out), _w(want_out.shape, 99), np.inf)
    want, want_g = _run(jnd, jag, arrays, op, attrs, w)
    got, got_g = _run(tnd, tag, arrays, op, attrs, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for g, e in zip(got_g, want_g):
        err = np.linalg.norm(g - e) / max(np.linalg.norm(e), 1e-12)
        assert err < GRAD_REL_L2, err


@pytest.mark.parametrize("shape,target", [((2, 4, 5, 6), (11, 13)),
                                          ((2, 4, 7), (14,))])
def test_deconvolution_target_shape_follows_reference(shape, target):
    """``target_shape`` sets pad and adj as the reference's
    ``DeconvolutionParam::InferPad`` (the JAX op ignores it)."""
    n = len(target)
    x = tnd.array(_w(shape, 0))
    w = tnd.array(_w((4, 3) + (3,) * n, 1))
    out = tnd.Deconvolution(x, w, kernel=(3,) * n, stride=(2,) * n,
                            target_shape=target, num_filter=3)
    assert out.shape[2:] == target
    pad, adj = tmx.ops.nn.deconv_geometry(
        shape[2:], (3,) * n, (2,) * n, (1,) * n, (0,) * n, (0,) * n, target)
    ref = tnd.Deconvolution(x, w, kernel=(3,) * n, stride=(2,) * n, pad=pad,
                            adj=adj, num_filter=3)
    np.testing.assert_array_equal(out.asnumpy(), ref.asnumpy())


def test_new_layers_defer_init_and_infer_shapes():
    net = tgluon.nn.HybridSequential()
    with net.name_scope():
        net.add(tgluon.nn.Conv2DTranspose(5, 3, 2, 1),
                tgluon.nn.InstanceNorm(), tgluon.nn.PReLU(),
                tgluon.nn.Identity())
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    out = net(tnd.array(_w((2, 3, 4, 4), 0)))
    assert out.shape == (2, 5, 7, 7)
    shapes = {n: p.shape for n, p in net.collect_params().items()}
    assert shapes[net.prefix + "conv0_weight"] == (3, 5, 3, 3)
    assert shapes[net.prefix + "instancenorm0_gamma"] == (5,)
    assert shapes[net.prefix + "prelu0_alpha"] == (1,)


def test_conv_layers_refuse_other_layouts():
    with pytest.raises(NotImplementedError):
        tgluon.nn.Conv2D(4, 3, layout="NHWC")
