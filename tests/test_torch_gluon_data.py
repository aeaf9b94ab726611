"""``gluon.data`` of the port against the JAX package's, on the CPU.

- Datasets (``SimpleDataset``, ``ArrayDataset``, ``transform``,
  ``transform_first``, ``RecordFileDataset`` over a RecordIO file the
  test writes), samplers (sequential, random with numpy's global
  generator seeded alike, batch with ``keep`` / ``discard`` /
  ``rollover``) and the ``DataLoader`` with 0 and 2 workers: the same
  batches, in the same order, as the JAX package's loader with 0
  workers (both shuffle in the main process with numpy). Workers are
  spawned and hidden from every CUDA device.
- ``MNIST`` / ``FashionMNIST`` on idx files the test writes (gzip and
  raw), ``CIFAR10`` / ``CIFAR100`` on binary batches the test writes and,
  against the JAX package's readers, on python batches.
- The transforms: ``Cast``, ``ToTensor``, ``Normalize``, the flips and
  the colour jitters with Python's and numpy's generators seeded alike,
  within 1e-4 of the JAX package's (float32 image arithmetic).
- ``utils.check_sha1`` and ``utils.download`` (which raises).
"""
import gzip
import hashlib
import pickle
import random
import struct

import numpy as np
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import data as jdata

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tt
from torch_threads import one_torch_thread  # noqa: F401

from mxnet_tpu.gluon.data.vision import transforms as jt


@pytest.fixture(autouse=True)
def _cpu_scope():
    with tmx.cpu():
        yield


def _arrays(n=10):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 3, 2)).astype(np.float32),
            np.arange(n, dtype=np.float32))


def _as_np(batch):
    if isinstance(batch, (list, tuple)):
        return [_as_np(b) for b in batch]
    return batch.asnumpy() if hasattr(batch, "asnumpy") else np.asarray(batch)


def test_datasets_and_transforms_match_jax():
    x, y = _arrays()
    jds, tds = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)
    assert len(tds) == len(jds) == 10
    for i in (0, 3, 9):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(_as_np(a), _as_np(b))
    tt_ = tds.transform_first(lambda v: v * 2)
    jt_ = jds.transform_first(lambda v: v * 2)
    np.testing.assert_array_equal(tt_[4][0], jt_[4][0])
    assert tt_[4][1] == jt_[4][1]
    eager = tds.transform(lambda a, b: (a.sum(), b), lazy=False)
    assert isinstance(eager, tdata.SimpleDataset)
    np.testing.assert_allclose(eager[2][0], x[2].sum(), rtol=1e-6)
    with pytest.raises(ValueError):
        tdata.ArrayDataset(x, y[:3])


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    np.random.seed(3)
    j = list(jdata.RandomSampler(11))
    np.random.seed(3)
    t = list(tdata.RandomSampler(11))
    assert t == j and sorted(t) == list(range(11))
    assert list(tdata.SequentialSampler(4)) == [0, 1, 2, 3]
    jb = jdata.BatchSampler(jdata.SequentialSampler(11), 4, last_batch)
    tb = tdata.BatchSampler(tdata.SequentialSampler(11), 4, last_batch)
    assert [list(tb), list(tb), len(tb)] == [list(jb), list(jb), len(jb)]


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_matches_jax_order(workers):
    x, y = _arrays(13)
    np.random.seed(5)
    want = [_as_np(b) for b in jdata.DataLoader(
        jdata.ArrayDataset(x, y), batch_size=4, shuffle=True,
        last_batch="keep")]
    np.random.seed(5)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                              shuffle=True, last_batch="keep",
                              num_workers=workers)
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 4
    for g, w in zip(got, want):
        assert isinstance(g[0], tnd.NDArray) and g[0].context == tmx.cpu()
        for a, b in zip(_as_np(g), w):
            np.testing.assert_array_equal(a, b)


def _write_records(tmp_path, n=7):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    return rec


@pytest.mark.parametrize("workers", [0, 2])
def test_record_file_dataset_through_the_loader(workers, tmp_path):
    rec = _write_records(tmp_path)
    tds = tdata.RecordFileDataset(rec)
    jds = jdata.RecordFileDataset(rec)
    assert len(tds) == len(jds) == 7
    assert [tds[i] for i in range(7)] == [jds[i] for i in range(7)]
    lens = tds.transform(len, lazy=False)
    loader = tdata.DataLoader(lens, batch_size=3, num_workers=workers)
    got = [b.asnumpy().tolist() for b in loader]
    assert got == [[1, 2, 3], [4, 5, 6], [7]]
    # the main process's reader still works after the workers ran
    assert tds[6] == bytes([6]) * 7


def _write_idx(path, arr, magic, gz):
    head = struct.pack(">I", magic) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [True, False])
def test_mnist_readers_match_jax(gz, tmp_path):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (5, 28, 28))
    labels = rng.integers(0, 10, 5)
    suffix = ".gz" if gz else ""
    for train, (fi, fl) in ((True, tdata.vision.MNIST._train_data),
                            (False, tdata.vision.MNIST._test_data)):
        _write_idx(str(tmp_path / fi[:-3]) + suffix, imgs, 2051, gz)
        _write_idx(str(tmp_path / fl[:-3]) + suffix, labels, 2049, gz)
    for cls in ("MNIST", "FashionMNIST"):
        t = getattr(tdata.vision, cls)(root=str(tmp_path), train=False)
        j = getattr(jdata.vision, cls)(root=str(tmp_path), train=False)
        assert len(t) == len(j) == 5
        for i in range(5):
            np.testing.assert_array_equal(t[i][0].asnumpy(),
                                          j[i][0].asnumpy())
            assert t[i][1] == j[i][1]
        assert t[0][0].shape == (28, 28, 1) and t[0][0].dtype == np.uint8
    with pytest.raises(tmx.MXNetError):
        tdata.vision.MNIST(root=str(tmp_path / "missing"))


def test_cifar_readers_on_binary_and_python_batches(tmp_path):
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, (6, 3072)).astype(np.uint8)
    labels = rng.integers(0, 10, 6).astype(np.uint8)
    fine = rng.integers(0, 100, 6).astype(np.uint8)
    want = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    # binary batches (the reference's format)
    (tmp_path / "bin" / "cifar-10-batches-bin").mkdir(parents=True)
    (tmp_path / "bin" / "cifar-10-batches-bin" / "test_batch.bin").write_bytes(
        np.concatenate([labels[:, None], raw], 1).tobytes())
    t = tdata.vision.CIFAR10(root=str(tmp_path / "bin"), train=False)
    np.testing.assert_array_equal(np.stack([t[i][0].asnumpy()
                                            for i in range(6)]), want)
    assert [t[i][1] for i in range(6)] == labels.tolist()
    (tmp_path / "bin" / "cifar-100-binary").mkdir()
    (tmp_path / "bin" / "cifar-100-binary" / "test.bin").write_bytes(
        np.concatenate([labels[:, None], fine[:, None], raw], 1).tobytes())
    t100 = tdata.vision.CIFAR100(root=str(tmp_path / "bin"), train=False,
                                 fine_label=True)
    assert [t100[i][1] for i in range(6)] == fine.tolist()
    # python batches (the JAX package's format), against its reader
    (tmp_path / "py" / "cifar-10-batches-py").mkdir(parents=True)
    with open(tmp_path / "py" / "cifar-10-batches-py" / "test_batch",
              "wb") as f:
        pickle.dump({b"data": raw, b"labels": labels.tolist()}, f)
    t = tdata.vision.CIFAR10(root=str(tmp_path / "py"), train=False)
    j = jdata.vision.CIFAR10(root=str(tmp_path / "py"), train=False)
    for i in range(6):
        np.testing.assert_array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert t[i][1] == j[i][1]


def test_cifar_python_batches_refuse_other_objects(tmp_path):
    (tmp_path / "cifar-10-batches-py").mkdir()
    with open(tmp_path / "cifar-10-batches-py" / "test_batch", "wb") as f:
        pickle.dump({b"data": random.Random(0)}, f)
    with pytest.raises(pickle.UnpicklingError):
        tdata.vision.CIFAR10(root=str(tmp_path), train=False)


def test_synthetic_dataset_matches_jax():
    t = tdata.vision.SyntheticImageDataset(4, (3, 8, 8), 10, seed=2)
    j = jdata.vision.SyntheticImageDataset(4, (3, 8, 8), 10, seed=2)
    for i in range(4):
        np.testing.assert_array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert t[i][1] == j[i][1]


def _img(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (6, 5, 3)).astype(
        np.uint8)


DETERMINISTIC = [
    ("Cast", lambda m: m.Cast("float16")),
    ("ToTensor", lambda m: m.ToTensor()),
    ("Compose", lambda m: m.Compose([m.ToTensor(),
                                     m.Normalize((0.5, 0.4, 0.3),
                                                 (0.2, 0.25, 0.3))])),
]
RANDOM = [
    ("RandomFlipLeftRight", lambda m: m.RandomFlipLeftRight()),
    ("RandomFlipTopBottom", lambda m: m.RandomFlipTopBottom()),
    ("RandomBrightness", lambda m: m.RandomBrightness(0.4)),
    ("RandomContrast", lambda m: m.RandomContrast(0.4)),
    ("RandomSaturation", lambda m: m.RandomSaturation(0.4)),
    ("RandomHue", lambda m: m.RandomHue(0.3)),
    ("RandomColorJitter", lambda m: m.RandomColorJitter(0.3, 0.3, 0.3, 0.2)),
    ("RandomLighting", lambda m: m.RandomLighting(0.1)),
]


@pytest.mark.parametrize("name,make", DETERMINISTIC + RANDOM,
                         ids=[n for n, _ in DETERMINISTIC + RANDOM])
def test_transforms_match_jax(name, make):
    x = _img()
    got, want = [], []
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        got.append(make(tt)(tnd.array(x, dtype="uint8")).asnumpy())
        random.seed(seed)
        np.random.seed(seed)
        want.append(make(jt)(jnd.array(x, dtype="uint8")).asnumpy())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-5,
                                   atol=1e-4)


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "f.bin"
    f.write_bytes(b"gluon")
    assert tmx.gluon.utils.check_sha1(str(f),
                                      hashlib.sha1(b"gluon").hexdigest())
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(tmx.MXNetError, match="network"):
        tmx.gluon.utils.download("http://example.invalid/x", str(tmp_path))
