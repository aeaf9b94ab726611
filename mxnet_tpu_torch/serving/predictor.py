"""Predictor: a frozen, bucketed inference program (counterpart of
``mxnet_tpu/serving/predictor.py``).

Parameters are staged on the device once (cast to the compute dtype when
one is set), the rewrite pipeline (``pallas_fusion``, then
``residual_fusion``) is applied to the predict graph, and each request
pads up to the nearest configured batch bucket, so a mixed stream of
request sizes runs a small fixed set of batch shapes. Oversized requests
split into largest-bucket chunks. The forward runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import numpy as np
import torch

from .. import config
from ..base import MXNetError, torch_dtype
from ..context import as_device
from ..symbol import passes as _passes

__all__ = ["Predictor", "default_buckets"]

_IDS = itertools.count()


def default_buckets():
    """Bucket set from MXTPU_SERVING_BUCKETS (ascending, deduped)."""
    raw = str(config.get("MXTPU_SERVING_BUCKETS"))
    try:
        buckets = sorted({int(x) for x in raw.replace(" ", "").split(",")
                          if x})
    except ValueError:
        raise MXNetError(f"MXTPU_SERVING_BUCKETS={raw!r} is not a "
                         "comma-separated integer list") from None
    if not buckets or buckets[0] < 1:
        raise MXNetError(f"MXTPU_SERVING_BUCKETS={raw!r} must name "
                         "positive batch sizes")
    return tuple(buckets)


class Predictor:
    """Inference program over a frozen symbol + params.

    Parameters
    ----------
    symbol : Symbol
        The model graph; SoftmaxOutput & co evaluate in inference mode.
    arg_params / aux_params : dict name -> array or tensor
        Parameter and auxiliary values (numpy arrays, tensors, or
        anything with ``asnumpy()``); staged on ``device`` once.
    data_names : sequence of str
        Inputs fed per request. Other arguments must be in ``arg_params``
        unless their leading dim tracks the batch (a label head input),
        in which case they are zero-filled.
    data_shapes : dict name -> per-row feature shape (no batch dim)
    buckets : tuple of int, optional
        Ascending batch buckets (default MXTPU_SERVING_BUCKETS).
    compute_dtype : str or torch.dtype, optional
        e.g. "bfloat16": float32 params are cast once at staging and
        inputs per call; outputs return float32.
    apply_fusion : bool, optional
        Force the ``pallas_fusion`` rewrite on/off (default: the
        MXTPU_PALLAS_FUSION flag, whose ``auto`` is on for CUDA).
    device : str or torch.device, optional
        Default ``cuda:0``; raises when CUDA is absent and no device is
        given.
    """

    def __init__(self, symbol, arg_params, aux_params=None,
                 data_names=("data",), data_shapes=None, buckets=None,
                 compute_dtype=None, apply_fusion=None, device=None):
        self.device = as_device(device)
        self.symbol = symbol
        self.data_names = list(data_names)
        self.buckets = tuple(sorted(set(buckets))) if buckets \
            else default_buckets()
        if data_shapes is None:
            raise MXNetError("Predictor needs data_shapes={name: per-row "
                             "feature shape}; buckets give the batch dim")
        self.data_shapes = {n: tuple(s) for n, s in data_shapes.items()}
        for n in self.data_names:
            if n not in self.data_shapes:
                raise MXNetError(f"data_shapes missing entry for '{n}'")
        self._cdt = torch_dtype(compute_dtype)
        aux_params = aux_params or {}
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in arg_names
                            if n not in self.data_names]

        # shapes at two batch sizes tell what tracks the batch: which
        # non-param args are label inputs to zero-fill, and which outputs
        # carry a batch axis to trim
        top = self.buckets[-1]

        def _infer(b):
            a, o, x = symbol.infer_shape(**{
                n: (b,) + self.data_shapes[n] for n in self.data_names})
            return dict(zip(arg_names, a)), list(o), dict(zip(aux_names, x))

        arg_shape_map, out_shapes, aux_shape_map = _infer(top)
        arg_alt, out_alt, _ = _infer(top + 1)

        def _tracks_batch(s_top, s_alt):
            return bool(s_top) and s_top[0] == top and s_alt[0] == top + 1

        self.out_batched = [_tracks_batch(s, sa)
                            for s, sa in zip(out_shapes, out_alt)]
        self._zero_args = []
        missing = []
        for n in self.param_names:
            if n in arg_params:
                continue
            if _tracks_batch(arg_shape_map[n], arg_alt[n]):
                self._zero_args.append(n)
            else:
                missing.append(n)
        if missing:
            raise MXNetError(f"Predictor missing parameters {missing}")
        for n in aux_names:
            if n not in aux_params:
                raise MXNetError(f"Predictor missing aux state '{n}'")
        self._zero_shapes = {n: tuple(arg_shape_map[n][1:])
                             for n in self._zero_args}
        self._params = {n: self._stage_value(arg_params[n],
                                             arg_shape_map[n], n)
                        for n in self.param_names
                        if n not in self._zero_args}
        self._params.update({n: self._stage_value(aux_params[n],
                                                  aux_shape_map[n], n)
                             for n in aux_names})

        # the predict-program rewrite pipeline, applicability judged at
        # the largest bucket's shapes
        shapes = dict(arg_shape_map)
        shapes.update(aux_shape_map)
        force = contextlib.nullcontext()
        if apply_fusion is not None:
            force = config.override("MXTPU_PALLAS_FUSION",
                                    "1" if apply_fusion else "0")
        with force:
            fused_sym, self.pass_report = _passes.apply_pipeline(
                symbol, shapes, tag="predictor", mode="serving",
                device=self.device, compute_dtype=self._cdt,
                data_names=set(self.data_names) | set(self._zero_args))
        self.fusion_report = _passes.legacy_fusion_entry(self.pass_report)
        self._run_sym = fused_sym if fused_sym is not None else symbol

        self.telemetry_id = f"{symbol.name or 'predictor'}#{next(_IDS)}"
        self._lock = threading.Lock()
        self._bucket_calls = {b: 0 for b in self.buckets}
        self._bucket_rows = {b: 0 for b in self.buckets}
        self._bucket_pad_rows = {b: 0 for b in self.buckets}

    # -- parameter staging ----------------------------------------------------
    def _stage_value(self, v, want_shape, name):
        """Shape-check one param/aux value and put it on the device, cast
        to the compute dtype when it is float32."""
        if isinstance(v, torch.Tensor):
            t = v.detach()
        else:
            a = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            t = torch.tensor(a)
        if tuple(t.shape) != tuple(want_shape):
            raise MXNetError(f"Predictor param '{name}' has shape "
                             f"{tuple(t.shape)}, inferred "
                             f"{tuple(want_shape)}")
        if self._cdt is not None and t.dtype == torch.float32:
            t = t.to(self._cdt)
        return t.to(self.device).contiguous()

    # -- bucketing ------------------------------------------------------------
    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket >= n, or the largest bucket (callers chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- execution ------------------------------------------------------------
    def _forward(self, inputs):
        """The predict program on device tensors (one per data name, the
        bucket's rows each): outputs as device tensors."""
        amap = dict(self._params)
        bsz = inputs[0].shape[0]
        for n, v in zip(self.data_names, inputs):
            if self._cdt is not None and v.dtype == torch.float32:
                v = v.to(self._cdt)
            amap[n] = v
        for n in self._zero_args:
            amap[n] = torch.zeros((bsz,) + self._zero_shapes[n],
                                  dtype=torch.float32, device=self.device)
        outs = self._run_sym.eval_arrays(amap)
        return [o.float() if self._cdt is not None and o.dtype == self._cdt
                else o for o in outs]

    def _run_bucket(self, arrays, rows, bucket):
        """Pad name-ordered request arrays to ``bucket`` rows and run the
        program. Returns trimmed numpy outputs."""
        padded = []
        for a in arrays:
            if a.dtype == np.float64:   # as the JAX package (no x64)
                a = a.astype(np.float32)
            if rows != bucket:
                pad = np.zeros((bucket - rows,) + a.shape[1:], a.dtype)
                a = np.concatenate([a, pad], axis=0)
            padded.append(torch.from_numpy(np.ascontiguousarray(a)))
        with self._lock, torch.inference_mode():
            outs = self._forward([t.to(self.device) for t in padded])
            outs = [o.cpu().numpy() for o in outs]
            self._bucket_calls[bucket] += 1
            self._bucket_rows[bucket] += rows
            self._bucket_pad_rows[bucket] += bucket - rows
        return [o[:rows] if batched else o
                for o, batched in zip(outs, self.out_batched)]

    def normalize_request(self, data):
        """Validate one request; returns ``(arrays, rows)`` with numpy
        arrays ordered by ``data_names``. Shared by ``predict`` and
        ``DynamicBatcher.submit`` so both reject identically."""
        if not isinstance(data, dict):
            data = {self.data_names[0]: data}
        arrays = []
        for n in self.data_names:
            if n not in data:
                raise MXNetError(f"request missing data input '{n}'")
            v = data[n]
            a = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            if tuple(a.shape[1:]) != self.data_shapes[n]:
                raise MXNetError(
                    f"request input '{n}' rows have shape "
                    f"{tuple(a.shape[1:])}, expected {self.data_shapes[n]}")
            arrays.append(a)
        n_rows = arrays[0].shape[0]
        if n_rows < 1:
            raise MXNetError("got an empty (0-row) request")
        if any(a.shape[0] != n_rows for a in arrays):
            raise MXNetError("request inputs disagree on batch size")
        return arrays, n_rows

    def predict(self, data):
        """Run inference on one request: an array (single data input) or
        a dict name -> array, any leading batch size. Returns one numpy
        array (single output) or a list."""
        arrays, n_rows = self.normalize_request(data)
        chunks = []
        for start in range(0, n_rows, self.max_batch):
            rows = min(n_rows - start, self.max_batch)
            chunks.append(self._run_bucket(
                [a[start:start + rows] for a in arrays], rows,
                self.bucket_for(rows)))
        if len(chunks) == 1:
            outs = chunks[0]
        else:
            outs = [np.concatenate([c[i] for c in chunks], axis=0)
                    if batched else chunks[0][i]
                    for i, batched in enumerate(self.out_batched)]
        return outs[0] if len(outs) == 1 else outs

    def warmup(self):
        """Run every bucket once, so no live request pays first-call costs
        (kernel builds, Triton compiles, cuDNN algorithm choice)."""
        for b in self.buckets:
            self._run_bucket([np.zeros((b,) + self.data_shapes[n],
                                       np.float32)
                              for n in self.data_names], b, b)

    # -- observability --------------------------------------------------------
    def report(self, reset=False):
        with self._lock:
            out = {
                "id": self.telemetry_id,
                "device": str(self.device),
                "buckets": list(self.buckets),
                "per_bucket": {
                    b: {"calls": self._bucket_calls[b],
                        "rows": self._bucket_rows[b],
                        "pad_rows": self._bucket_pad_rows[b]}
                    for b in self.buckets},
                "fused_sites": len(self.fusion_report["sites"])
                if self.fusion_report else 0,
                "pass_sites": {
                    e["pass"]: len(e["sites"])
                    for e in self.pass_report["passes"]
                    if e["status"] == "applied"},
                "compute_dtype": str(self._cdt) if self._cdt else None,
            }
            if reset:
                for b in self.buckets:
                    self._bucket_calls[b] = 0
                    self._bucket_rows[b] = 0
                    self._bucket_pad_rows[b] = 0
        return out
