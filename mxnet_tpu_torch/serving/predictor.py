"""Predictor: a frozen, bucketed inference program (counterpart of
``mxnet_tpu/serving/predictor.py``).

Parameters are staged on the device once (cast to the compute dtype when
one is set), the rewrite pipeline (``pallas_fusion``, then
``residual_fusion``) is applied to the predict graph, and each request
pads up to the nearest configured batch bucket, so a mixed stream of
request sizes runs a small fixed set of batch shapes. Oversized requests
split into largest-bucket chunks. The forward runs under
``torch.inference_mode()``.

On a CUDA device each (bucket, request dtypes) is one captured program,
as each is one compiled XLA program in the JAX package: a CUDA graph
keyed by ``compile.program_key("predictor", ...)`` and noted by the
retrace guard, captured at its first call (``warmup()`` calls every
bucket) after one eager warm-up forward. A call stages the request's
rows through a pinned host buffer into the static input in chunks (the
host copy of one chunk overlaps the transfer of the last), zeroes the
padding rows on the card, replays the graph and copies the outputs into
pinned host buffers, then synchronises once. Calls are serialised by
the predictor's lock and their outputs leave before it is released, so
all buckets share one graph memory pool. A capture on a thread other
than the main one (a bucket first seen by a batcher thread) uses
``capture_error_mode="thread_local"``. A capture that fails raises.
``predict_eager`` runs the same forward without a graph (for an A/B);
the CPU always runs eagerly, unpinned, and keys its programs all the
same, so ``retraces`` and ``compile_report()`` read alike on both.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import compile as compile_mod
from .. import config
from ..base import MXNetError, torch_dtype
from ..context import as_device
from ..dtype import resolve_dtype
from ..symbol import passes as _passes
from ..telemetry import trace as _trace
from . import _register_predictor

__all__ = ["Predictor", "default_buckets"]

_STAGE_CHUNKS = 8     # chunks of a request's staging through pinned memory


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

        _register_predictor(self)
        self._programs = {}     # (bucket, dtypes) -> CapturedProgram
        self._materialized = 0  # programs acquired BY this instance
        self._pool = None       # the buckets' shared graph memory pool
        self._symbol_sha = None
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

    @property
    def captured(self):
        """True when buckets run as captured CUDA graphs."""
        return self.device.type == "cuda"

    @property
    def retraces(self):
        """Programs this predictor acquired (compile-registry accounting;
        on the card, CUDA graphs captured): at most one per bucket and
        request dtypes after warmup."""
        return self._materialized

    # -- compile registry (compile/ package) ----------------------------------
    def _program_key(self, bucket, dtypes):
        """The JAX package's predictor key materials
        (``mxnet_tpu/serving/predictor.py`` ``_program_key``), less the
        donation and hoisting ones this port lacks."""
        if self._symbol_sha is None:
            self._symbol_sha = compile_mod.symbol_digest(self.symbol)
        sigs = tuple((n, (bucket,) + tuple(self.data_shapes[n]), dt)
                     for n, dt in zip(self.data_names, dtypes))
        fusion = {"flag": str(config.get("MXTPU_PALLAS_FUSION")),
                  "sites": len(self.fusion_report["sites"])
                  if self.fusion_report else 0}
        extra = {"compute_dtype": str(self._cdt).replace("torch.", ""),
                 "zero_args": sorted(self._zero_args)}
        return compile_mod.program_key(
            "predictor", f"predictor:{self.symbol.name}:b{bucket}",
            symbol_sha=self._symbol_sha, input_sigs=sigs, fusion=fusion,
            passes=_passes.pipeline_key_material(self.pass_report),
            extra=extra, device=self.device)

    def _program(self, bucket, dtypes):
        """The program of ``bucket`` at the request's input dtypes (numpy
        names, one per data name): acquired (and on the card captured) at
        first use. Call under ``self._lock``."""
        prog = self._programs.get((bucket, dtypes))
        if prog is not None:
            return prog
        key = self._program_key(bucket, dtypes)
        shapes = [(bucket,) + self.data_shapes[n] for n in self.data_names]
        compile_mod.note_entry_point(key.name, key,
                                     tuple(zip(shapes, dtypes)))
        prog = compile_mod.CapturedProgram(key)
        if self.captured:
            self._capture(prog, shapes, dtypes)
        self._programs[(bucket, dtypes)] = prog
        self._materialized += 1
        return prog

    def _capture(self, prog, shapes, dtypes):
        """Pinned and static input buffers, one eager warm-up forward on a
        side stream, the capture, then pinned output buffers shaped like
        the captured outputs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog.pool = self._pool
        prog.pinned_in = [torch.empty(s, dtype=resolve_dtype(d),
                                      pin_memory=True)
                          for s, d in zip(shapes, dtypes)]
        prog.static = [torch.zeros(s, dtype=resolve_dtype(d),
                                   device=self.device)
                       for s, d in zip(shapes, dtypes)]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            self._forward(prog.static)
        main.wait_stream(side)
        side.synchronize()
        mode = "global" if threading.current_thread() is \
            threading.main_thread() else "thread_local"
        try:
            with torch.inference_mode():
                prog.capture(lambda: self._forward(prog.static),
                             capture_error_mode=mode,
                             arguments=list(self._params.values()))
        except Exception as e:
            raise MXNetError(f"capturing {prog.key.name} as a CUDA graph "
                             f"failed: {e}") from e
        prog.pinned_out = [torch.empty(o.shape, dtype=o.dtype,
                                       pin_memory=True)
                           for o in prog.outputs]

    def _copy_in(self, prog, arrays, rows):
        """The request's rows through the pinned buffers to the static
        inputs, in up to ``_STAGE_CHUNKS`` chunks: the host copy of a
        chunk (a float64 request cast on the way) overlaps the transfer
        of the one before. The padding rows are zeroed on the card."""
        step = -(-rows // _STAGE_CHUNKS)
        for pin, st, a in zip(prog.pinned_in, prog.static, arrays):
            host = pin.numpy()
            for i in range(0, rows, step):
                j = min(i + step, rows)
                host[i:j] = a[i:j]
                st[i:j].copy_(pin[i:j], non_blocking=True)
            if rows < st.shape[0]:
                st[rows:].zero_()

    def _copy_out(self, prog):
        """The outputs into the pinned buffers, one synchronize; numpy
        copies (the buffers serve the next call)."""
        for po, o in zip(prog.pinned_out, prog.outputs):
            po.copy_(o, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [po.numpy().copy() for po in prog.pinned_out]

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

    def _run_bucket(self, arrays, rows, bucket, eager=False):
        """Pad name-ordered request arrays to ``bucket`` rows and run the
        bucket's program (on the card its CUDA graph, unless ``eager``).
        Returns trimmed numpy outputs."""
        # float64 runs as float32, as in the JAX package (no x64)
        dtypes = tuple("float32" if a.dtype == np.float64 else a.dtype.name
                       for a in arrays)
        with self._lock, torch.inference_mode(), _trace.span(
                f"serving:bucket{bucket}", cat="serving",
                args={"predictor": self.telemetry_id, "rows": rows,
                      "pad_rows": bucket - rows}):
            if self.captured and not eager:
                prog = self._program(bucket, dtypes)
                self._copy_in(prog, arrays, rows)
                prog.replay()
                outs = self._copy_out(prog)
            else:
                if not self.captured:
                    self._program(bucket, dtypes)
                padded = [a.astype(dt, copy=False) if rows == bucket
                          else np.concatenate([a.astype(dt, copy=False),
                                               np.zeros((bucket - rows,)
                                                        + a.shape[1:], dt)])
                          for a, dt in zip(arrays, dtypes)]
                outs = self._forward([torch.from_numpy(
                    np.ascontiguousarray(a)).to(self.device)
                    for a in padded])
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
        return self._predict(data, eager=False)

    def predict_eager(self, data):
        """``predict`` without the captured graphs: the forward's kernels
        launched from Python, pageable copies (the same as ``predict``
        on the CPU)."""
        return self._predict(data, eager=True)

    def _predict(self, data, eager):
        arrays, n_rows = self.normalize_request(data)
        chunks = []
        for start in range(0, n_rows, self.max_batch):
            rows = min(n_rows - start, self.max_batch)
            chunks.append(self._run_bucket(
                [a[start:start + rows] for a in arrays], rows,
                self.bucket_for(rows), eager))
        if len(chunks) == 1:
            outs = chunks[0]
        else:
            outs = [np.concatenate([c[i] for c in chunks], axis=0)
                    if batched else chunks[0][i]
                    for i, batched in enumerate(self.out_batched)]
        return outs[0] if len(outs) == 1 else outs

    def warmup(self):
        """Run every bucket once, so no live request pays first-call costs
        (kernel builds, Triton compiles, cuDNN algorithm choice, and on
        the card the bucket's capture). Returns ``retraces``."""
        for b in self.buckets:
            self._run_bucket([np.zeros((b,) + self.data_shapes[n],
                                       np.float32)
                              for n in self.data_names], b, b)
        return self.retraces

    # -- observability --------------------------------------------------------
    def program_memory(self, bucket=None):
        """The memory row recorded when ``bucket``'s program (largest
        bucket by default) was captured (``telemetry.memory``), or
        ``{}`` (not captured yet, or the CPU). Never captures again."""
        b = self.buckets[-1] if bucket is None else bucket
        for (bk, _dt), prog in self._programs.items():
            if bk == b and prog.memory:
                return dict(prog.memory)
        return {}

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
                "retraces": self._materialized,
                "captured": self.captured,
            }
            if reset:
                for b in self.buckets:
                    self._bucket_calls[b] = 0
                    self._bucket_rows[b] = 0
                    self._bucket_pad_rows[b] = 0
        return out
