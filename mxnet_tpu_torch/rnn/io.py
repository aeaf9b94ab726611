"""Bucketing data iterator for variable-length sequences (counterpart
of ``mxnet_tpu/rnn/io.py``; reference: python/mxnet/rnn/io.py:78).

The batches are the JAX package's for the same seeds: the same padding,
the same shuffles (Python's ``random`` over the batch index, numpy's
global RNG over each bucket) and next-token labels shifted inside each
padded bucket. They are host NDArrays (CPU tensors): ``fit``'s data
pipeline, or the bound executor, moves them to the module's device.
"""
from __future__ import annotations

import bisect
import logging
import random

import numpy as np

from .. import ndarray as nd
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Pads sentences into length buckets; each batch carries its
    ``bucket_key`` so that ``BucketingModule`` switches to that bucket
    (reference: rnn/io.py:78)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sentence in sentences:
            buck = bisect.bisect_left(buckets, len(sentence))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sentence)] = sentence
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket.", ndiscard)
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)
        self.provide_data = [DataDesc(self.data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(self.label_name, shape,
                                       layout=layout)]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        """(reference: rnn/io.py:165)"""
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=cpu(), dtype=self.dtype))

    def next(self):
        """(reference: rnn/io.py:181)"""
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape,
                                                 layout=self.layout)])
