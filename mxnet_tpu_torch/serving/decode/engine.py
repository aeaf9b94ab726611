"""DecodePredictor: KV-cached autoregressive serving programs and slots
(counterpart of ``mxnet_tpu/serving/decode/engine.py``).

The engine freezes a ``TransformerLMSpec`` weight set into the program
families iterative decode needs (model.py):

- one PREFILL program per prompt-length bucket, batch 1: fills the
  request's lane of the KV-cache and emits token #1. Every admission runs
  the same program whether the server is idle or saturated, which is
  half of the bit-identity guarantee;
- ONE DECODE program that advances all ``slots`` lanes one token. Lanes
  are independent and the program always runs every lane, so each
  product has one shape (one cuBLAS algorithm) whatever the occupancy:
  the other half;
- one VERIFY program per declared width (``verify_widths``, set by the
  speculative predictor), all lanes up to K tokens in one launch;
- a REPREFILL program per bucket, the cacheless baseline of the bytes
  comparison, acquired lazily (not a serving program).

On the card each program is a CUDA graph (``compile.CapturedProgram``)
keyed by ``compile.program_key("decode", ...)`` under the JAX package's
labels (``decode:<name>:prefill:s<b>``, ``decode:<name>:decode``,
``decode:<name>:verify:k<w>``, ``decode:<name>:reprefill:s<b>``) and
noted by the retrace guard. Its first call runs eagerly on a side stream
(that call's result; it warms Triton and cuBLAS), then it is captured
(``capture_error_mode="thread_local"`` off the main thread); later calls
replay. ``warmup()`` acquires every serving program before live traffic.
A capture that fails raises: there is no fallback to eager execution.

The KV-cache is persistent device state (``2 * num_layers`` f32 buffers
of ``(slots, max_seq, heads, head_dim)``, or ``4 * num_layers`` int8
value and f32 scale buffers), written in place by every program: the
counterpart of the JAX package's donation (``donate`` in the key). A
call packs its host inputs (tokens, positions, active flags, length,
slot) into one int32 array, copies it through a pinned buffer into the
program's static input, replays, and copies the emitted tokens back
through a pinned buffer with the one synchronisation a step needs (the
batcher routes tokens per lane). The CPU runs the same functions
eagerly, keys its programs all the same, and reads the same report.

Not ported: the persistent program cache and the degrade-to-plain-jit
fallback, the telemetry registry (``report()`` keeps plain counters) and
``memory_report()``'s ``decode_state`` row (``kv_cache_bytes()`` is the
live buffers' bytes), ``from_module`` (waits for the port's training of
this model). ``program_cost`` is a count from shapes, not a compiler's
cost analysis.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ... import compile as compile_mod
from ... import config
from ...base import MXNetError
from ...context import as_device
from .. import _register_decoder
from . import model as _model

__all__ = ["DecodePredictor", "default_seq_buckets"]


def default_seq_buckets(max_seq):
    """Prompt-length buckets from MXTPU_DECODE_SEQ_BUCKETS, clipped to
    ``max_seq`` (which is always a bucket: any prompt the spec admits has
    a program)."""
    raw = str(config.get("MXTPU_DECODE_SEQ_BUCKETS"))
    try:
        buckets = sorted({int(x) for x in raw.replace(" ", "").split(",")
                          if x})
    except ValueError:
        raise MXNetError(
            f"MXTPU_DECODE_SEQ_BUCKETS={raw!r} is not a comma-separated "
            "integer list") from None
    if buckets and buckets[0] < 1:
        raise MXNetError(
            f"MXTPU_DECODE_SEQ_BUCKETS={raw!r} must name positive "
            "prompt lengths")
    buckets = [b for b in buckets if b <= max_seq]
    if not buckets or buckets[-1] != max_seq:
        buckets.append(max_seq)
    return tuple(buckets)


def _layout(kv_dtype):
    return ("slot-major:int8+f32scale" if kv_dtype == "int8"
            else "slot-major:f32")


class DecodePredictor:
    """KV-cached decode serving over a frozen transformer LM.

    Parameters
    ----------
    spec : TransformerLMSpec
    params : dict name -> numpy array or tensor
        Weights matching ``spec.param_shapes()`` (``init_params``, or the
        JAX package's dict through ``interop.decode_params_from_jax``);
        staged on ``device`` as float32 once.
    slots : int, optional
        Concurrent generation lanes (default MXTPU_DECODE_SLOTS).
    seq_buckets : tuple of int, optional
        Prompt-length buckets (default MXTPU_DECODE_SEQ_BUCKETS, clipped
        to ``spec.max_seq``, which is always included).
    name : str, optional
        Label of the programs (default ``spec.name``).
    kv_dtype : str, optional
        ``"float32"`` or ``"int8"`` (default MXTPU_DECODE_KV_DTYPE).
    device : str or torch.device, optional
        Default ``cuda:0``; raises when CUDA is absent and no device is
        given.
    """

    def __init__(self, spec, params, slots=None, seq_buckets=None,
                 name=None, kv_dtype=None, device=None):
        self.device = as_device(device)
        self.spec = spec
        self.name = name or spec.name
        self.slots = int(slots) if slots is not None \
            else int(config.get("MXTPU_DECODE_SLOTS"))
        if self.slots < 1:
            raise MXNetError(f"slots={self.slots} must be >= 1")
        self.kv_dtype = _model.check_kv_dtype(
            kv_dtype if kv_dtype is not None
            else config.get("MXTPU_DECODE_KV_DTYPE"))
        self.buckets = tuple(sorted(set(
            int(b) for b in seq_buckets))) if seq_buckets \
            else default_seq_buckets(spec.max_seq)
        if self.buckets[-1] > spec.max_seq:
            raise MXNetError(
                f"seq bucket {self.buckets[-1]} exceeds "
                f"spec.max_seq={spec.max_seq}")

        shapes = spec.param_shapes()
        missing = [n for n in shapes if n not in params]
        if missing:
            raise MXNetError(f"DecodePredictor missing params {missing}")
        self._p = {}
        for n, want in shapes.items():
            v = params[n]
            t = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.asarray(
                    getattr(v, "_data", v), dtype=np.float32))
            if tuple(t.shape) != tuple(want):
                raise MXNetError(
                    f"param '{n}' has shape {tuple(t.shape)}, spec wants "
                    f"{tuple(want)}")
            self._p[n] = t.to(self.device, torch.float32).contiguous()
        self._caches = _model.init_caches(spec, self.slots, self.kv_dtype,
                                          self.device)
        # multi-token verify widths warmup acquires; empty on a plain
        # engine, (k+1,) on a SpecDecodePredictor
        self.verify_widths = ()

        self._lock = threading.RLock()
        self._programs = {}       # ("prefill", b) / ("decode",) / ...
        self._program_costs = {}
        self._pool = None         # the programs' shared graph memory pool
        self._materialized = 0
        self._free = list(range(self.slots))      # LIFO slot allocator
        self._slot_pos = [0] * self.slots         # next write position
        self._decode_steps = 0
        self._verify_steps = 0
        self._prefills = 0
        self._tokens = 0
        _register_decoder(self)

    # -- bucketing / capacity -------------------------------------------------
    @property
    def captured(self):
        """True when the programs run as captured CUDA graphs."""
        return self.device.type == "cuda"

    @property
    def max_batch(self):
        """Decode lanes (the DecodeBatcher's concurrency bound)."""
        return self.slots

    @property
    def retraces(self):
        """Programs this engine acquired (on the card, CUDA graphs
        captured)."""
        return self._materialized

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise MXNetError(
            f"prompt of {n} tokens exceeds the largest seq bucket "
            f"({self.buckets[-1]})")

    def gen_limit(self, prompt_len, max_new_tokens=None):
        """Max tokens producible for a prompt: the cache holds positions
        ``[0, max_seq)``, so generation is capped at ``max_seq -
        prompt_len + 1`` (token #1 costs no cache row). Solo ``generate``
        and the batcher clamp through here."""
        cap = self.spec.max_seq - prompt_len + 1
        if max_new_tokens is None:
            return cap
        return max(1, min(int(max_new_tokens), cap))

    def check_prompt(self, prompt):
        """Validate/convert one prompt to a 1-D int32 numpy array."""
        a = np.asarray(getattr(prompt, "_data", prompt))
        if a.ndim != 1 or a.shape[0] < 1:
            raise MXNetError(
                f"prompt must be a non-empty 1-D token sequence, got "
                f"shape {tuple(a.shape)}")
        if a.shape[0] > self.spec.max_seq:
            raise MXNetError(
                f"prompt of {a.shape[0]} tokens exceeds "
                f"max_seq={self.spec.max_seq}")
        return a.astype(np.int32)

    # -- programs -------------------------------------------------------------
    def _program_key(self, kind, bucket=None):
        extra = dict(self.spec.key_material())
        extra.update({
            "slots": self.slots,
            "cache_layout": _layout(self.kv_dtype) if kind != "reprefill"
            else "none",
            # the cache is updated in place: the counterpart of donation
            "donate": kind != "reprefill",
        })
        if kind == "verify":
            sigs = (("tokens", (self.slots, bucket), "int32"),)
            label = f"decode:{self.name}:verify:k{bucket}"
        else:
            sigs = ((("tokens", (1, bucket), "int32"),)
                    if bucket is not None
                    else (("tokens", (self.slots,), "int32"),))
            label = f"decode:{self.name}:{kind}" + \
                (f":s{bucket}" if bucket is not None else "")
        return compile_mod.program_key("decode", label, input_sigs=sigs,
                                       extra=extra, device=self.device)

    def _fn(self, kind, bucket):
        """The program of ``kind`` as a function of its packed int32
        input: returns (tokens, logits) device tensors."""
        spec, p, caches, kd = self.spec, self._p, self._caches, \
            self.kv_dtype
        if kind == "prefill":
            b = bucket

            def fn(buf):                      # (b + 2,): tokens, length, slot
                nxt, logits = _model._prefill(spec, p, caches,
                                              buf[:b].view(1, b), buf[b],
                                              buf[b + 1], kd)
                return nxt.reshape(1), logits
        elif kind == "decode":
            def fn(buf):                      # (3, slots)
                return _model._decode(spec, p, caches, buf[0], buf[1],
                                      buf[2] != 0, kd)
        elif kind == "verify":
            w = bucket

            def fn(buf):                      # (slots, w + 3)
                return _model._verify(spec, p, caches, buf[:, :w],
                                      buf[:, w], buf[:, w + 1],
                                      buf[:, w + 2] != 0, kd)
        else:
            b = bucket

            def fn(buf):                      # (b + 1,): tokens, length
                return _model.reprefill_step(spec, p, buf[:b].view(1, b),
                                             buf[b]).reshape(1), None
        return fn

    def _program(self, pkey_id, kind, bucket, buf):
        """The program of ``pkey_id``, acquired at its first call (call
        under ``self._lock``). Returns ``(prog, outputs)``: ``outputs``
        is this call's result when the acquisition ran it (the eager
        warm-up run on the card, the eager run on the CPU), else None."""
        prog = self._programs.get(pkey_id)
        if prog is not None:
            return prog, None
        key = self._program_key(kind, bucket)
        compile_mod.note_entry_point(key.name, key,
                                     ((tuple(buf.shape), "int32"),))
        prog = compile_mod.CapturedProgram(key)
        prog.fn = self._fn(kind, bucket)
        self._program_costs[pkey_id] = self._count(kind, bucket)
        outs = None
        if self.captured:
            outs = self._capture(prog, buf)
        self._programs[pkey_id] = prog
        self._materialized += 1
        return prog, outs

    def _capture(self, prog, buf):
        """Static and pinned buffers, the call's own eager run on a side
        stream (its result is returned), then the capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog.pool = self._pool
        prog.pinned_in = torch.empty(buf.shape, dtype=torch.int32,
                                     pin_memory=True)
        prog.static = torch.empty(buf.shape, dtype=torch.int32,
                                  device=self.device)
        self._stage(prog, buf)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            outs = [o.clone() if o is not None else None
                    for o in prog.fn(prog.static)]
        main.wait_stream(side)
        side.synchronize()
        mode = "global" if threading.current_thread() is \
            threading.main_thread() else "thread_local"
        try:
            with torch.inference_mode():
                prog.capture(lambda: prog.fn(prog.static),
                             capture_error_mode=mode)
        except Exception as e:
            raise MXNetError(f"capturing {prog.key.name} as a CUDA graph "
                             f"failed: {e}") from e
        prog.pinned_out = torch.empty(prog.outputs[0].shape,
                                      dtype=torch.int32, pin_memory=True)
        return outs

    def _stage(self, prog, buf):
        host = prog.pinned_in.numpy()
        host[...] = buf
        prog.static.copy_(prog.pinned_in, non_blocking=True)

    def _call(self, pkey_id, kind, bucket, buf, eager=False):
        """Run one program on the packed int32 host input ``buf``:
        (tokens, logits) as device tensors (on the card the graph's
        output buffers, valid until the next call). ``eager`` runs its
        function without the graph (the captured-vs-eager check). Call
        under ``self._lock``."""
        prog, outs = self._program(pkey_id, kind, bucket, buf)
        if outs is not None:
            return outs
        with torch.inference_mode():
            if not self.captured or eager:
                return prog.fn(torch.from_numpy(buf).to(self.device))
            self._stage(prog, buf)
            prog.replay()
        return prog.outputs

    def _tokens_out(self, pkey_id, kind, bucket, buf):
        """``_call`` and the emitted tokens to the host: one copy through
        the program's pinned buffer and one synchronisation."""
        nxt = self._call(pkey_id, kind, bucket, buf)[0]
        if not self.captured:
            return nxt.numpy().copy()
        prog = self._programs[pkey_id]
        prog.pinned_out.copy_(nxt, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return prog.pinned_out.numpy().copy()

    # -- slot allocator -------------------------------------------------------
    def alloc_slot(self):
        """Claim a free decode lane, or None when saturated."""
        with self._lock:
            return self._free.pop() if self._free else None

    def release(self, slot):
        """Return a lane to the pool (stale cache rows need no scrub: the
        next prefill overwrites its rows and attention masks beyond the
        live position with an exact-zero contribution)."""
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)

    @property
    def free_slots(self):
        with self._lock:
            return len(self._free)

    def slot_pos(self, slot):
        """A lane's committed write position (next row index)."""
        with self._lock:
            return self._slot_pos[slot]

    def seek_slot(self, slot, pos):
        """Set a lane's committed position: the speculative layer commits
        an accepted prefix through here, and a lane import lands its
        transferred position."""
        if not 0 <= int(pos) <= self.spec.max_seq:
            raise MXNetError(
                f"seek_slot position {pos} outside [0, "
                f"{self.spec.max_seq}]")
        with self._lock:
            self._slot_pos[slot] = int(pos)

    # -- packed inputs --------------------------------------------------------
    def _prefill_buf(self, slot, prompt, bucket):
        buf = np.zeros(bucket + 2, np.int32)
        buf[:prompt.shape[0]] = prompt
        buf[bucket] = prompt.shape[0]
        buf[bucket + 1] = slot
        return buf

    def _decode_buf(self, slot_tokens):
        """(3, slots): tokens, positions, active; under ``self._lock``."""
        buf = np.zeros((3, self.slots), np.int32)
        for slot, tok in slot_tokens.items():
            buf[:, slot] = (tok, self._slot_pos[slot], 1)
        return buf

    def _verify_buf(self, slot_feed, width):
        """(slots, width + 3): tokens, positions, n_tokens, active."""
        buf = np.zeros((self.slots, width + 3), np.int32)
        buf[:, width + 1] = 1
        for slot, fed in slot_feed.items():
            n = len(fed)
            buf[slot, :n] = fed
            buf[slot, width:] = (self._slot_pos[slot], n, 1)
        return buf

    # -- execution ------------------------------------------------------------
    def prefill(self, slot, prompt):
        """Fill ``slot`` from a validated prompt; returns token #1."""
        prompt = self.check_prompt(prompt)
        plen = prompt.shape[0]
        bucket = self.bucket_for(plen)
        buf = self._prefill_buf(slot, prompt, bucket)
        with self._lock:
            nxt = self._tokens_out(("prefill", bucket), "prefill", bucket,
                                   buf)
            self._slot_pos[slot] = plen
            self._prefills += 1
            self._tokens += 1
        return int(nxt[0])

    def decode(self, slot_tokens):
        """One decode step: ``{slot: previous_token}`` for every active
        lane -> ``{slot: next_token}``. Consults the ``decode_step`` fault
        site (1-based ``token`` ordinal) BEFORE touching device state, so
        an injected raise or kill leaves the cache un-advanced."""
        if not slot_tokens:
            return {}
        from ... import faultinject
        with self._lock:
            ordinal = self._decode_steps + 1
            if faultinject.fire("decode_step", token=ordinal):
                armed = faultinject.active("decode_step") or {}
                if armed.get("action") != "sleep":
                    raise faultinject.FaultInjected("decode_step",
                                                    token=ordinal)
                # sleep-armed (the slow-decode drill): fire() already
                # stretched this step, the program still runs
            nxt = self._tokens_out(("decode",), "decode", None,
                                   self._decode_buf(slot_tokens))
            self._decode_steps += 1
            for slot in slot_tokens:
                self._slot_pos[slot] += 1
            self._tokens += len(slot_tokens)
        return {slot: int(nxt[slot]) for slot in slot_tokens}

    def _verify_width_for(self, n):
        for w in self.verify_widths:
            if n <= w:
                return w
        return n

    def verify(self, slot_feed):
        """One multi-token verify step: ``{slot: fed_tokens}`` (the last
        committed token, then draft proposals) -> ``{slot: np.int32
        array}`` of the target's argmax after each fed token. Lanes pad
        to the smallest declared width that fits. Positions are NOT
        advanced: the caller commits the accepted prefix with
        ``seek_slot``, so a rejected draft's rows just go stale."""
        if not slot_feed:
            return {}
        counts = {s: len(f) for s, f in slot_feed.items()}
        if min(counts.values()) < 1:
            raise MXNetError("verify needs at least the committed "
                             "token per lane")
        width = self._verify_width_for(max(counts.values()))
        if width > self.spec.max_seq:
            raise MXNetError(f"verify width {width} exceeds max_seq="
                             f"{self.spec.max_seq}")
        with self._lock:
            outs = self._tokens_out(("verify", width), "verify", width,
                                    self._verify_buf(slot_feed, width))
            self._verify_steps += 1
        return {slot: outs[slot, :counts[slot]].copy()
                for slot in slot_feed}

    # -- KV-lane handoff (disaggregated prefill/decode) -----------------------
    def lane_fingerprint(self):
        """Layout key a lane must match to transfer between engines: spec
        material and cache layout (not the slot count)."""
        return dict(self.spec.key_material(),
                    cache_layout=_layout(self.kv_dtype))

    def export_lane(self, slot):
        """Snapshot one lane's cache rows and committed position as host
        arrays (under int8 the quantized buffers: ~0.3x the f32 bytes)."""
        with self._lock:
            # a copy also on the CPU, where .cpu() would alias the cache
            rows = [c[slot].to("cpu", copy=True).numpy()
                    for c in self._caches]
            pos = self._slot_pos[slot]
        return {
            "fingerprint": self.lane_fingerprint(),
            "pos": int(pos),
            "rows": rows,
            "bytes": int(sum(r.nbytes for r in rows)),
        }

    def import_lane(self, slot, lane, prompt=None):
        """Land an exported lane into a free local slot, in place. Refuses
        a fingerprint mismatch. ``prompt`` is unused here: subclasses with
        per-lane state of their own (the speculative predictor's draft
        cache) rebuild it from the prompt."""
        if lane["fingerprint"] != self.lane_fingerprint():
            raise MXNetError(
                f"KV-lane fingerprint mismatch: exporter "
                f"{lane['fingerprint']} vs importer "
                f"{self.lane_fingerprint()}; handoff requires identical "
                "spec and cache layout")
        rows = lane["rows"]
        with self._lock:
            if len(rows) != len(self._caches):
                raise MXNetError(
                    f"KV-lane has {len(rows)} buffers, cache has "
                    f"{len(self._caches)}")
            for c, r in zip(self._caches, rows):
                c[slot].copy_(torch.from_numpy(np.asarray(r)))
            self._slot_pos[slot] = int(lane["pos"])

    def generate(self, prompt, max_new_tokens=None, stop_token=None):
        """Stream tokens for ONE prompt (a generator): the solo surface
        over the same slot allocator and programs the continuous batcher
        drives, which is why batched streams equal it bit for bit.
        Yields ints, ``stop_token`` included; stops at
        ``max_new_tokens`` or when the cache is full (``gen_limit``)."""
        prompt = self.check_prompt(prompt)
        limit = self.gen_limit(prompt.shape[0], max_new_tokens)
        slot = self.alloc_slot()
        if slot is None:
            raise MXNetError(
                f"no free decode slot ({self.slots} busy); generate() is "
                "the solo surface, use DecodeBatcher for concurrent load")
        try:
            tok = self.prefill(slot, prompt)
            produced = 1
            yield tok
            while produced < limit and \
                    (stop_token is None or tok != stop_token):
                tok = self.decode({slot: tok})[slot]
                produced += 1
                yield tok
        finally:
            self.release(slot)

    def warmup(self):
        """Acquire (on the card: run once and capture) every serving
        program: per-bucket prefill, the decode step, each declared
        verify width. Slot 0's scratch prefill rows are harmless (see
        ``release``); the decode and verify runs have no active lane.
        Returns the programs acquired so far: serving after warmup
        acquires none."""
        with self._lock:
            for b in self.buckets:
                if ("prefill", b) not in self._programs:
                    buf = np.zeros(b + 2, np.int32)
                    buf[b] = 1
                    self._call(("prefill", b), "prefill", b, buf)
            if ("decode",) not in self._programs:
                self._call(("decode",), "decode", None,
                           np.zeros((3, self.slots), np.int32))
            for w in self.verify_widths:
                if ("verify", w) not in self._programs:
                    buf = np.zeros((self.slots, w + 3), np.int32)
                    buf[:, w + 1] = 1
                    self._call(("verify", w), "verify", w, buf)
            if self.captured:
                torch.cuda.current_stream(self.device).synchronize()
        return self.retraces

    # -- byte counts ----------------------------------------------------------
    def kv_cache_bytes(self):
        """The live cache buffers' bytes; equals ``spec.kv_cache_bytes(
        slots, kv_dtype)``."""
        return int(sum(c.numel() * c.element_size() for c in self._caches))

    def _count(self, kind, bucket):
        """``program_cost``'s count for one program, from shapes."""
        s = self.spec
        d, f, v, L = s.num_embed, s.ffn_hidden, s.vocab_size, s.num_layers
        layer = 4 * (3 * d * d + d * d + 2 * f * d + 4 * d)
        weights = L * layer + 4 * (v * d + 2 * d)
        row = (s.head_dim + 4 if self.kv_dtype == "int8"
               else 4 * s.head_dim) * s.num_heads
        per_tok = 2 * (L * (4 * d * d + 2 * f * d) + v * d)
        if kind in ("prefill", "reprefill"):
            n = bucket
            inputs = 4 * (n + (2 if kind == "prefill" else 1))
            cache_in, cache_out = 0, (L * 2 * n * row
                                      if kind == "prefill" else 0)
            attn = 4 * n * n * d * L
            outputs = 4 + 4 * v
        else:
            w = 1 if kind == "decode" else bucket
            n = self.slots * w
            inputs = 4 * self.slots * (w + 3)
            cache_in = L * 2 * self.slots * s.max_seq * row
            cache_out = L * 2 * n * row
            attn = 4 * n * s.max_seq * d * L
            outputs = 4 * n * (1 + v)
        return {"bytes accessed": float(weights + 2 * 4 * n * d + inputs
                                        + cache_in + cache_out + outputs),
                "flops": float(n * per_tok + attn)}

    def program_cost(self, kind, bucket=None):
        """Bytes and flops of one acquired program ({} before it is
        acquired), COUNTED from shapes and dtypes, not measured:
        ``bytes accessed`` = every weight matrix and LN vector once, the
        gathered embedding rows (``2 * rows * embed * 4``), the packed
        int32 inputs, the cache rows read (decode and verify: every
        lane's ``max_seq`` rows of K and V in every layer, the most the
        decode-attention kernel reads; it stops at each lane's position),
        the cache rows written, and the tokens and logits written;
        intermediates are not counted. ``flops`` = 2 per weight per
        token row, plus ``4 * rows * keys * embed`` per layer of
        attention."""
        pkey_id = (kind, bucket) if bucket is not None else (kind,)
        return dict(self._program_costs.get(pkey_id) or {})

    def decode_bytes_per_token(self):
        """The decode step's counted bytes (``program_cost``) divided by
        the lanes it advances: the per-token cost of cached decode."""
        b = self.program_cost("decode").get("bytes accessed")
        return b / self.slots if b else None

    def reprefill_bytes_per_token(self, bucket=None):
        """Counted bytes of the cacheless re-prefill baseline at a seq
        bucket: what one token costs a server that recomputes the whole
        prompt. Its program is acquired here, lazily (a baseline, not a
        serving program: warmup leaves it out)."""
        b = self.buckets[-1] if bucket is None else bucket
        with self._lock:
            if ("reprefill", b) not in self._programs:
                buf = np.zeros(b + 1, np.int32)
                buf[b] = b
                self._call(("reprefill", b), "reprefill", b, buf)
        return self.program_cost("reprefill", b).get("bytes accessed")

    # -- observability --------------------------------------------------------
    def report(self, reset=False):
        with self._lock:
            out = {
                "id": self.telemetry_id,
                "slots": self.slots,
                "seq_buckets": list(self.buckets),
                "max_seq": self.spec.max_seq,
                "free_slots": len(self._free),
                "retraces": self._materialized,
                "prefills": self._prefills,
                "decode_steps": self._decode_steps,
                "verify_steps": self._verify_steps,
                "tokens": self._tokens,
                "kv_dtype": self.kv_dtype,
                "kv_cache_bytes": self.kv_cache_bytes(),
                "kv_cache_accounted_bytes":
                    self.spec.kv_cache_bytes(self.slots,
                                             kv_dtype=self.kv_dtype),
                "kv_cache_f32_bytes":
                    self.spec.kv_cache_bytes(self.slots),
                "decode_bytes_per_token": self.decode_bytes_per_token(),
                "donate": True,
                "captured": self.captured,
            }
            if reset:
                self._prefills = 0
                self._decode_steps = 0
                self._verify_steps = 0
                self._tokens = 0
        return out
