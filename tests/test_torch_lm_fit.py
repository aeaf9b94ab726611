"""The decode LM's training symbol and its training through
``Module.fit`` in the port, against the JAX package's, on the CPU.

- ``build_symbol``: the same arguments, outputs and JSON node for node;
  ``infer_shape(data=(b, s))`` gives the same argument, output and aux
  shapes (``pos_emb_weight`` sized by its declared shape alone); each
  package loads the other's JSON.
- The train-mode pass report of the LM graph: ``pallas_fusion`` and
  ``residual_fusion`` forced on are ``skipped`` with the reason
  ``embedding_graph`` in both packages, and the port's pipeline does not
  raise for a CUDA program (``device=cuda:0``; nothing runs there).
- ``Module.fit`` with Adam (lr 3e-3) for 3 steps from the same weights
  (the JAX package's Xavier draw carried over with
  ``interop.params_from_jax``), ``shuffle=False``, ``Accuracy(axis=2)``
  counted in the step: every weight within 1e-3 of its 3-step update's
  largest entry (+1e-6; measured 6e-5: Adam divides by sqrt(v), so a
  gradient differing in its last bits moves an element whose v is tiny
  by more than 1e-6 of the step), and the accuracy within 2 positions of
  the 1,536 counted (measured: equal). ``score`` with the same metric
  over the same batches within the same limit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.serving.decode import model as jmodel
from mxnet_tpu.symbol import passes as jax_passes

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving.decode import model as tmodel
from mxnet_tpu_torch.symbol import passes as torch_passes

SPECS = {
    "bench_draft": dict(vocab_size=30, num_embed=32, num_heads=2,
                        num_layers=2, max_seq=64),
    "odd": dict(vocab_size=41, num_embed=24, num_heads=3, num_layers=1,
                max_seq=20, ffn_hidden=40),
}
FIT_SEQ = 16
FIT_BATCH = 32
FIT_STEPS = 3
PARAM_REL_TO_UPDATE = 1e-3
ACC_POSITIONS = 2


def _pair(kw, seq_len):
    # each package numbers unnamed nodes (the position slice) with its own
    # process-wide counter: a fresh NameManager on each side makes the two
    # graphs' automatic names independent of what the process built before
    with jmx.name.NameManager():
        js = jmodel.build_symbol(jmodel.TransformerLMSpec(**kw), seq_len)
    with tmx.name.NameManager():
        ts = tmodel.build_symbol(tmodel.TransformerLMSpec(**kw), seq_len)
    return js, ts


@pytest.mark.parametrize("case", sorted(SPECS))
def test_build_symbol_matches_the_jax_package(case):
    kw = SPECS[case]
    seq = min(16, kw["max_seq"])
    js, ts = _pair(kw, seq)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == []
    assert set(ts.list_arguments()) == \
        set(tmodel.TransformerLMSpec(**kw).param_shapes()) | \
        {"data", "softmax_label"}
    assert ts.tojson() == js.tojson()
    ja = js.infer_shape(data=(4, seq))
    ta = ts.infer_shape(data=(4, seq))
    assert [list(map(tuple, x)) for x in ta] == \
        [list(map(tuple, x)) for x in ja]
    shapes = dict(zip(ts.list_arguments(), ta[0]))
    want = tmodel.TransformerLMSpec(**kw).param_shapes()
    assert {n: tuple(shapes[n]) for n in want} == want
    assert tuple(ta[1][0]) == (4, seq, kw["vocab_size"])
    assert tmx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert jmx.sym.load_json(ts.tojson()).tojson() == ts.tojson()


def test_build_symbol_refuses_a_sequence_past_max_seq():
    with pytest.raises(tmx.MXNetError):
        tmodel.build_symbol(tmodel.TransformerLMSpec(10, max_seq=8), 9)


def test_layer_norm_output_mean_var_symbol_matches():
    jd, td = jmx.sym.Variable("data"), tmx.sym.Variable("data")
    js = jmx.sym.LayerNorm(jd, axis=1, output_mean_var=True, name="ln")
    ts = tmx.sym.LayerNorm(td, axis=1, output_mean_var=True, name="ln")
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.tojson() == js.tojson()
    ja, ta = js.infer_shape(data=(2, 5, 3)), ts.infer_shape(data=(2, 5, 3))
    assert [list(map(tuple, x)) for x in ta] == \
        [list(map(tuple, x)) for x in ja]


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_pass_report_skips_the_embedding_graph(device):
    js, ts = _pair(SPECS["bench_draft"], FIT_SEQ)
    a, _, _ = ts.infer_shape(data=(FIT_BATCH, FIT_SEQ))
    shapes = dict(zip(ts.list_arguments(), map(tuple, a)))
    with jmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            jmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        _, jrep = jax_passes.apply_pipeline(
            js, shapes, tag="fused_step", mode="train",
            batch_names={"data", "softmax_label"})
    with tmx.config.override("MXTPU_PALLAS_FUSION", "1"), \
            tmx.config.override("MXTPU_PASS_RESIDUAL_FUSION", "1"):
        new, trep = torch_passes.apply_pipeline(
            ts, shapes, tag="fused_step", mode="train",
            device=torch.device(device),
            data_names={"data", "softmax_label"})
    assert new is None
    je = {e["pass"]: e for e in jrep["passes"]}
    te = {e["pass"]: e for e in trep["passes"]}
    for name in ("pallas_fusion", "residual_fusion"):
        assert te[name]["status"] == je[name]["status"] == "skipped"
        assert te[name]["reason"] == je[name]["reason"] == "embedding_graph"


def test_a_conv_graph_with_an_embedding_keeps_its_rewrites():
    """Only an embedding graph without a convolution is skipped."""
    from mxnet_tpu_torch.symbol.passes.base import (PassContext,
                                                    embedding_skip_reason)
    sym = tmx.sym
    emb = sym.Embedding(sym.Variable("ids"), input_dim=5, output_dim=4,
                        name="emb")
    conv = sym.Convolution(sym.Variable("data"), kernel=(1, 1),
                           num_filter=4, name="conv")
    mixed = sym.Group([emb, conv])
    assert embedding_skip_reason(PassContext("t", symbol=mixed)) is None
    assert embedding_skip_reason(PassContext("t", symbol=emb)) == \
        "embedding_graph"
    assert embedding_skip_reason(PassContext("t", symbol=conv)) is None


def _corpus_windows(n_rows):
    corpus = ("the quick brown fox jumps over the lazy dog. "
              "pack my box with five dozen liquor jugs. ") * 4
    chars = sorted(set(corpus))
    ids = np.asarray([chars.index(c) for c in corpus], np.int32)
    data = np.stack([ids[i:i + FIT_SEQ] for i in range(n_rows)])
    label = np.stack([ids[i + 1:i + FIT_SEQ + 1] for i in range(n_rows)])
    return len(chars), data.astype(np.float32), label.astype(np.float32)


def test_module_fit_adam_matches_the_jax_package():
    vocab, data, label = _corpus_windows(FIT_BATCH * FIT_STEPS)
    kw = dict(vocab_size=vocab, num_embed=32, num_heads=4, num_layers=2,
              max_seq=32)
    js, ts = _pair(kw, FIT_SEQ)
    opt = {"learning_rate": 3e-3}

    jm = jmx.mod.Module(js, data_names=("data",),
                        label_names=("softmax_label",), context=jmx.cpu())
    jit_ = jmx.io.NDArrayIter(data, label, FIT_BATCH, shuffle=False)
    jm.bind(data_shapes=jit_.provide_data, label_shapes=jit_.provide_label)
    jm.init_params(jmx.init.Xavier())
    arg, aux = jm.get_params()
    init = {k: v.asnumpy().copy() for k, v in arg.items()}
    jmet = jmx.metric.Accuracy(axis=2)
    jm.fit(jit_, num_epoch=1, optimizer="adam", optimizer_params=opt,
           eval_metric=jmet, arg_params=arg, aux_params=aux)

    tm = tmx.mod.Module(ts, data_names=("data",),
                        label_names=("softmax_label",), context="cpu")
    tit = tmx.io.NDArrayIter(data, label, FIT_BATCH, shuffle=False)
    tm.bind(data_shapes=tit.provide_data, label_shapes=tit.provide_label)
    targ, taux = tmx.interop.params_from_jax(init, {}, "cpu")
    tm.init_params(arg_params=targ, aux_params=taux)
    tmet = tmx.metric.Accuracy(axis=2)
    tm.fit(tit, num_epoch=1, optimizer="adam", optimizer_params=opt,
           eval_metric=tmet)

    assert tm._fused is not None and tm._fused.num_update == FIT_STEPS
    jp = {k: v.asnumpy() for k, v in jm.get_params()[0].items()}
    tp = {k: v.numpy() for k, v in tm.get_params()[0].items()}
    assert sorted(tp) == sorted(jp)
    for n in jp:
        upd = np.abs(jp[n] - init[n]).max()
        err = np.abs(tp[n] - jp[n]).max()
        assert err <= PARAM_REL_TO_UPDATE * upd + 1e-6, (n, err, upd)
    n_pos = FIT_BATCH * FIT_STEPS * FIT_SEQ
    assert jmet.num_inst == tmet.num_inst == n_pos
    assert abs(tmet.get()[1] - jmet.get()[1]) <= ACC_POSITIONS / n_pos

    jsc = jm.score(jmx.io.NDArrayIter(data, label, FIT_BATCH),
                   jmx.metric.Accuracy(axis=2))
    tsc = tm.score(tmx.io.NDArrayIter(data, label, FIT_BATCH),
                   tmx.metric.Accuracy(axis=2))
    assert abs(tsc[0][1] - jsc[0][1]) <= ACC_POSITIONS / n_pos
