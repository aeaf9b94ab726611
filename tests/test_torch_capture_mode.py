"""The fused step's capture beside a ``DataPipeline``, within the port.

Under ``fit`` the pipeline's stager thread pins and copies the next
batches while the training step is captured. In the global capture
error mode such a call from another thread (a pinned allocation, an
event query) invalidates the capture, so the fused step captures in
the thread-local mode. The ``cpu`` case checks the mode the step hands
to its capture; the ``cuda`` case captures a step while a pipeline
streams host batches to the card, and skips on a machine without a
CUDA device (``python -m pytest --noconftest
tests/test_torch_capture_mode.py`` runs it there).
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.module.fused import FusedSymbolStep
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, DIM, BATCH, LEN = 50, 4, 8, 3


def _module(device):
    d = tmx.sym.Variable("data")
    e = tmx.sym.SparseEmbedding(data=d, input_dim=VOCAB, output_dim=DIM,
                                name="emb")
    f = tmx.sym.FullyConnected(tmx.sym.sum(e, axis=1), num_hidden=2,
                               name="fc")
    m = tmx.mod.Module(tmx.sym.SoftmaxOutput(f, name="softmax"),
                       context=device, fused=True)
    m.bind([("data", (BATCH, LEN))], [("softmax_label", (BATCH,))])
    m.init_params(tmx.init.Xavier(),
                  generator=torch.Generator().manual_seed(0))
    m.init_optimizer(optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1,
                                       "momentum": 0.9})
    return m


def _batch(device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, VOCAB, (BATCH, LEN))
                         .astype(np.int32))
    y = torch.from_numpy(rng.randint(0, 2, BATCH).astype(np.float32))
    return tmx.io.DataBatch([x.to(device)], [y.to(device)])


class _RecordingProgram:
    """Stands in for a CapturedProgram: records how it was captured."""

    def __init__(self):
        self.static = None
        self.kwargs = None

    def capture(self, fn, **kwargs):
        self.kwargs = kwargs


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_step_capture_holds_beside_the_stager(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only "
                    "on the card")
    dev = "cuda:0" if device == "cuda" else "cpu"
    m = _module(dev)
    b = _batch(dev)
    if device == "cpu":
        prog = _RecordingProgram()
        m._fused._capture(prog, {"data": b.data[0],
                                 "softmax_label": b.label[0]})
        assert prog.kwargs["capture_error_mode"] == "thread_local"
        assert set(prog.static) == {"data", "softmax_label"}
        return

    rng = np.random.RandomState(1)
    it = tmx.io.NDArrayIter(rng.rand(4096, 64).astype(np.float32),
                            np.zeros(4096, np.float32), 8)
    pipe = tmx.data.DataPipeline(it, sharding=dev, name="capture_mode")
    got, errors, stop = [0], [], threading.Event()

    def consume():
        try:
            torch.cuda.set_stream(torch.cuda.Stream(dev))
            while not stop.is_set():
                try:
                    pipe.next()
                except StopIteration:
                    pipe.reset()
                    continue
                got[0] += 1
        except Exception as e:      # noqa: BLE001 - asserted below
            errors.append(repr(e))

    m.forward(b, is_train=True)
    m.update()                      # the warm (eager) step
    torch.cuda.synchronize()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    try:
        deadline = time.perf_counter() + 30
        while got[0] < 20 and not errors and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        m.forward(b, is_train=True)
        m.update()                  # captured here, then replayed
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join(10)
        pipe.close()
    assert not errors
    assert not t.is_alive()
    assert sum(p.captured for p in m._fused._programs.values()) == 1
