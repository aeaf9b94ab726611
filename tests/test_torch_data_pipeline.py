"""The port's data pipeline, RecordIO and ``fit``'s wrapper against the
JAX package's, on the CPU.

- The pipelined stream is byte-identical to the unwrapped iterator's
  (data, label, pad) for 1 and 4 workers, over a shuffled
  ``NDArrayIter`` with a transform; the JAX package's pipeline gives
  the same bytes.
- RecordIO: files written by each package are equal byte for byte
  (records and ``.idx``) and each package reads the other's; the
  ``from_recordio`` streams of the two packages are equal.
- The cursor: a mid-epoch ``get_state`` resumes in a fresh pipeline at
  the exact next batch (NDArrayIter and RecordIO sources).
- ``fit`` with ``MXTPU_DATA_PIPELINE`` 1 and 0 gives the same
  parameters bit for bit; a checkpoint written with the flag in one
  position auto-resumes with it in the other.
- Faults: ``data_worker`` surfaces at ``next()`` and ``close()`` on full
  queues returns within its join limit. Every wait in these tests is
  bounded by a queue or join timeout, so a hang fails in seconds.
- ``data_report()`` counts the consumer's waits.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.data import pipeline as jpipe

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.data import pipeline as tpipe
from mxnet_tpu_torch.data import workers as twk
from torch_threads import one_torch_thread  # noqa: F401

JOIN_S = 5.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _stream(it, limit=100):
    out = []
    for _ in range(limit):
        try:
            b = it.next()
        except StopIteration:
            break
        out.append(([_np(a).tobytes() for a in b.data],
                    [_np(a).tobytes() for a in b.label or []], b.pad))
    return out


def _arrays(seed=0, n=45):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 4).astype(np.float32),
            rng.randint(0, 5, size=n).astype(np.float32))


def _scale(batch):
    from mxnet_tpu_torch.io import DataBatch
    return DataBatch(data=[d * 2 + 1 for d in batch.data],
                     label=batch.label, pad=batch.pad)


@pytest.mark.parametrize("workers", [1, 4])
def test_pipelined_stream_is_byte_identical(workers):
    d, l = _arrays()
    np.random.seed(3)
    base = tmx.io.NDArrayIter(d, l, 8, shuffle=True)
    np.random.seed(3)
    ref_it = tmx.io.NDArrayIter(d, l, 8, shuffle=True)
    ref = [([(_np(a) * 2 + 1).tobytes() for a in b[0]], b[1], b[2])
           for b in ((bb.data, [_np(x).tobytes() for x in bb.label],
                      bb.pad) for bb in ref_it)]
    pipe = tpipe.DataPipeline(base, transform=_scale, num_workers=workers,
                              sharding="cpu")
    try:
        got = _stream(pipe)
        assert got == ref and len(got) == 6
        pipe.reset()
        assert _stream(pipe) == ref          # the next epoch, the same
    finally:
        pipe.close()
    # the JAX package's pipeline over the same arrays: the same bytes
    jpl = jpipe.DataPipeline(jmx.io.NDArrayIter(d, l, 8), num_workers=2)
    tpl = tpipe.DataPipeline(tmx.io.NDArrayIter(d, l, 8), num_workers=2,
                             sharding="cpu")
    try:
        assert _stream(jpl) == _stream(tpl)
    finally:
        jpl.close()
        tpl.close()


def _write_records(mod, path, n=24):
    rng = np.random.RandomState(9)
    idx = os.path.splitext(path)[0] + ".idx"
    w = mod.MXIndexedRecordIO(idx, path, "w")
    for i in range(n):
        payload = rng.rand(2, 3).astype(np.float32).tobytes()
        label = float(i % 4) if i % 3 else rng.rand(2).astype(np.float32)
        w.write_idx(i, mod.pack(mod.IRHeader(0, label, i, 0), payload))
    w.close()
    return path, idx


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_recordio_files_are_interchangeable(tmp_path, writer, reader):
    mods = {"jax": jrec, "torch": trec}
    a = _write_records(jrec, str(tmp_path / "a.rec"))
    b = _write_records(trec, str(tmp_path / "b.rec"))
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
    src = a if writer == "jax" else b
    r = mods[reader].MXIndexedRecordIO(src[1], src[0], "r")
    w = mods[writer].MXIndexedRecordIO(src[1], src[0], "r")
    try:
        assert list(r.keys) == list(range(24))
        for k in (0, 7, 23, 5):
            hr, pr = mods[reader].unpack(r.read_idx(k))
            hw, pw = mods[writer].unpack(w.read_idx(k))
            assert pr == pw and hr.id == hw.id == k
            np.testing.assert_array_equal(np.asarray(hr.label),
                                          np.asarray(hw.label))
        r.reset()
        seq = [r.read() for _ in range(25)]
        assert seq[-1] is None and all(s is not None for s in seq[:-1])
    finally:
        r.close()
        w.close()
    # a record longer than one chunk's length field is split the same way
    big = bytes(range(256)) * 5
    for m, name in ((jrec, "j.rec"), (trec, "t.rec")):
        f = m.MXRecordIO(str(tmp_path / name), "w")
        f._MAX_CHUNK = 300       # force continuation chunks
        f.write(big)
        f.close()
    with open(tmp_path / "j.rec", "rb") as fj, \
            open(tmp_path / "t.rec", "rb") as ft:
        assert fj.read() == ft.read()
    assert trec.MXRecordIO(str(tmp_path / "j.rec"), "r").read() == big


def test_from_recordio_streams_match_the_jax_package(tmp_path):
    rec, _ = _write_records(trec, str(tmp_path / "d.rec"))
    jp = jpipe.from_recordio(rec, (2, 3), 4, shuffle=True, seed=5,
                             num_parts=1, part_index=0, num_workers=3)
    tp = tpipe.from_recordio(rec, (2, 3), 4, shuffle=True, seed=5,
                             num_workers=3, sharding="cpu")
    try:
        for _ in range(2):
            got, want = _stream(tp), _stream(jp)
            assert got == want and len(got) == 6
            tp.reset()
            jp.reset()
    finally:
        jp.close()
        tp.close()


def _make_source(kind, tmp_path):
    if kind == "ndarray":
        d, l = _arrays(1, 40)
        return tmx.io.NDArrayIter(d, l, 4, shuffle=True)
    rec, _ = _write_records(trec, str(tmp_path / "c.rec"), n=40)
    return tpipe.RecordIOSource(rec, batch_size=4, shuffle=True, seed=2)


@pytest.mark.parametrize("kind", ["ndarray", "recordio"])
def test_cursor_resumes_mid_epoch(tmp_path, kind):
    transform = None if kind == "ndarray" else \
        tpipe._default_record_decoder((2, 3), np.dtype(np.float32))
    np.random.seed(4)
    p1 = tpipe.DataPipeline(_make_source(kind, tmp_path),
                            transform=transform, num_workers=2,
                            sharding="cpu")
    try:
        full = _stream(p1)
        p1.reset()
        head = _stream(p1, limit=4)
        state = p1.get_state()
        rest = _stream(p1)           # the uninterrupted epoch's rest
    finally:
        p1.close()
    assert state["batch"] == 4 and state["epoch"] == 1
    np.random.seed(11)       # another shuffle: the cursor carries it
    p2 = tpipe.DataPipeline(_make_source(kind, tmp_path),
                            transform=transform, num_workers=3,
                            sharding="cpu")
    try:
        p2.set_state(state)
        tail = _stream(p2)
    finally:
        p2.close()
    assert len(full) == 10 and len(head) == 4
    assert tail == rest and len(tail) == 6
    if kind == "ndarray":      # NDArrayIter rewinds: the same stream
        assert head + tail == full
    with pytest.raises(ValueError, match="DataPipeline cursor"):
        p2.set_state({"cursor": 3, "rows": 40})


def _fit_params(flag, tmp_path=None, num_epoch=2, auto_resume=False,
                ckdir=None):
    d, l = _arrays(7, 48)
    d = d.reshape(48, 12)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=5, name="fc"), name="softmax")
    rng = np.random.RandomState(1)
    init = {"fc_weight": (rng.randn(5, 12) * 0.3).astype(np.float32),
            "fc_bias": np.zeros(5, np.float32)}
    with tmx.config.override("MXTPU_DATA_PIPELINE", flag):
        np.random.seed(0)
        mod = tmx.mod.Module(net, context="cpu")
        mod.fit(tmx.io.NDArrayIter(d, l, 8, shuffle=True),
                num_epoch=num_epoch, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params=init, checkpoint_manager=ckdir,
                auto_resume=auto_resume)
    return {n: v.numpy().copy() for n, v in mod.get_params()[0].items()}


def test_fit_gives_the_same_params_with_and_without_the_pipeline():
    on, off = _fit_params("1"), _fit_params("0")
    for n in on:
        np.testing.assert_array_equal(on[n], off[n], err_msg=n)


@pytest.mark.parametrize("first,second", [("1", "0"), ("0", "1")])
def test_fit_auto_resume_survives_the_flag_toggle(tmp_path, first,
                                                  second):
    ck = str(tmp_path / "ck")
    _fit_params(first, num_epoch=1, ckdir=ck)
    resumed = _fit_params(second, num_epoch=2, auto_resume=True, ckdir=ck)
    assert all(np.isfinite(v).all() for v in resumed.values())


def test_data_worker_fault_surfaces_at_next():
    d, l = _arrays()
    pipe = tpipe.DataPipeline(tmx.io.NDArrayIter(d, l, 5), num_workers=2,
                              sharding="cpu")
    got = []
    try:
        with tmx.faultinject.inject("data_worker:batch=3"):
            with pytest.raises(tmx.faultinject.FaultInjected,
                               match="data_worker"):
                for _ in range(20):
                    got.append(pipe.next())
            assert tmx.faultinject.fired("data_worker") == 1
    finally:
        t0 = time.monotonic()
        pipe.close()
        assert time.monotonic() - t0 < JOIN_S
    # the error cuts the epoch short: at most the two batches before it
    assert len(got) <= 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith("data-pipeline-")]


def test_close_returns_on_full_queues_and_report_counts_waits():
    d, l = _arrays(n=400)

    class Slow(tmx.io.NDArrayIter):
        def next(self):
            time.sleep(0.02)
            return super().next()

    tmx.data_report(reset=True)
    pipe = tpipe.DataPipeline(Slow(d, l, 4), num_workers=4, queue_depth=2,
                              stage_ahead=1, sharding="cpu", name="slowp")
    try:
        for _ in range(3):       # the consumer outruns the source: waits
            pipe.next()
        rep = tmx.data_report()
        assert rep["pipelines"]["slowp"]["waits"] >= 1
        assert rep["next_calls"] >= 3 and rep["wait_s"] > 0
        time.sleep(0.3)          # the producers fill every queue
    finally:
        t0 = time.monotonic()
        pipe.close()
        dt = time.monotonic() - t0
    assert dt < JOIN_S
    assert pipe._group is None
    assert pipe in list(twk._closeables)
    with pytest.raises(RuntimeError, match="closed"):
        pipe.next()
