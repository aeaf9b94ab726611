"""The fused training step of the symbolic Module (counterpart of
``mxnet_tpu/module/fused.py``), on one device.

``FusedSymbolStep.step`` runs a whole batch: the forward of the
rewritten graph in the compute dtype, the implicit-loss backward
(autograd), the optimizer update of the fp32 master weights and the
BatchNorm running-statistics fold. The rewrite passes run once, in
``train`` mode, at ``start``; on a CUDA device a pass that fails raises
(pass manager), so the step never trains on library ops in place of the
kernels.

On a CUDA device the step is a captured program, as the JAX package's is
one compiled XLA program: one CUDA graph per feed signature, keyed by
``compile.program_key("fused_step", ...)`` and noted by the retrace
guard. The first step at a signature runs eagerly on a side stream (it
warms Triton's JIT, the kernels' builds and attributes, cuDNN's
algorithm choice and the autograd engine's device thread); the next one
copies the feed into static input buffers, captures the step and
replays it; every later one is the copy, then ``replay()``. The base
learning rate is a 0-dim fp32 device scalar (``set_lr``, written before
each step) that the graph reads, so a schedule never needs a new capture;
so is the update count ``t`` (int32), which the step reads as ``t + 1``
and advances on every step, a skipped one included, as the JAX
package's ``_t_dev`` does: a replay never reuses a count baked in at
capture.
A replay's outputs live in the graph's memory and the next replay
overwrites them: ``step`` returns copies, and ``last_loss`` is one. A
capture that fails raises; there is no fallback to the eager step. The
capture runs in ``capture_error_mode="thread_local"``: under ``fit`` a
``DataPipeline``'s stager thread goes on pinning and copying the next
batches on a stream of its own while the step is captured, and in the
global mode any such call (a pinned allocation, an event query)
invalidates the capture. The CPU runs ``step_eager``, the same
arithmetic without a graph.

The optimizer is any rule of ``parallel/functional_opt.py``. Each
state leaf is parameter-shaped (one flat buffer laid out as the masters)
or 0-dim (nadam's ``m_schedule``: one buffer with an element per
parameter); sgd without momentum has none. sgld draws its noise from the
step's own device generator, registered with each captured graph.

Dtype flow (the JAX package's): fp32 master params, optimizer state
and aux; with a ``compute_dtype`` every fp32 param, aux and data input
is cast to it for the step, the gradients come back in fp32 (through
the cast), and the fold ``m*old + (1-m)*batch_stat`` is taken in the
compute dtype and stored in fp32. Labels keep their dtype: the JAX
package casts float32 labels too, and bf16 rounds a class index above
256 (999 becomes 1000, which its gather clamps; a CUDA gather asserts).

The non-finite step guard (``MXTPU_FT_GUARD``, on by default) is part
of the step: one fp32 scalar, the sum of |g| over every gradient,
decides whether the update lands. The update computes the new params,
momenta, aux and metric counters out of place and ``torch.where``
selects them or the old ones into the state, so a skipped step leaves
the state bit-identical and a clean step is bit-identical to the
unguarded update. The trainable masters, each optimizer-state leaf and
the aux each live in one flat fp32 buffer (a view per name, 256-byte aligned
for the masters), so a select is one launch per buffer, not one per
tensor. The device carries ``fault_state`` = [total skips,
consecutive skips] (int32[2]); ``fault.fault_report()`` reads it, and
``MXTPU_FT_MAX_CONSEC_SKIPS`` aborts from a copy of it taken K steps
earlier (pinned host memory and an event: no sync of the step).

In-step metric counters (``metric_device.py``): ``attach_metric`` gives
a metric a 0-dim device counter that the step advances, so
``update_metric`` reads nothing from the card. The guard flag and the
metric slots are key material: attaching a metric after a capture makes
exactly one new capture, which the retrace guard reports. Counters,
``fault_state``, momenta and masters keep their storage for the step's
life (a graph holds their addresses): resets and loads write into them.

``get_states`` / ``set_states`` serialize the optimizer state as the
JAX package's fused step does (the same pickled object, leaf for leaf,
for every rule; ``set_states`` sets ``t`` from ``num_update``), so
either package resumes from the other's file.

Row-sparse embedding routing (the JAX package's): ``start`` scans the
rewritten graph for ``SparseEmbedding`` sites (``sparse.find_sites``).
With a lazy rule (sgd, adam: ``lazy_update``) each routed table leaves
the differentiated set: the step gathers the rows its ids name and makes
them the leaf the backward differentiates, deduplicates that gradient to
sorted unique rows (``sparse.dedup_rows``) and applies it with
``row_update_``; no ``(vocab, dim)`` gradient exists in the program. A
routed table and each of its state leaves live in a buffer of their own
with one trash row past the end: the sentinel slots of the dedup and any
out-of-range id name it, and it never changes (a sentinel slot writes
back what it read); the table's views, ``params()``, ``get_states`` and
checkpoints expose only the real rows. The guard selects a routed
table's new rows against its old rows before the write, so it copies no
table. Without a lazy rule, or for a tied weight, a site takes the dense
path, counted in ``sparse::dense_fallback``. The sites are program-key
material; the ``sparse_update`` fault site and the host id statistics
(``sparse.note_step_ids``) run before each step.

Not ported (ROADMAP queue A): the device mesh and data-parallel batch
sharding, the ZeRO-1 sharded update, partition rules, the mesh-sharded
tables, the persistent program cache (a CUDA graph cannot be
serialized) and small-parameter packing (the
parameters of each (lr_mult, wd) group lie side by side in the flat
buffers instead, and an elementwise rule with parameter-shaped leaves
updates each group as one slice, its gradients gathered into one padded
buffer; lars, lbsgd's lars warmup and nadam update a view per
parameter).
"""
from __future__ import annotations

import collections
import math
import pickle
import weakref

import numpy as np
import torch

from .. import compile as compile_mod
from .. import config, fault, faultinject
from ..base import MXNetError, host_numpy, torch_dtype
from ..context import as_device
from ..executor import build_graph_fns
from ..parallel import functional_opt
from ..telemetry import timeline as _tlmod

__all__ = ["FusedSymbolStep"]

# the masters' views start at multiples of this many fp32 elements (256
# bytes): the fp32 step hands them to the kernels, which want aligned
# pointers
_ALIGN = 64


def _layout(shapes, align):
    """{name: (offset, shape)} of views packed into one buffer, each at a
    multiple of ``align`` elements, and the buffer's size."""
    out, off = {}, 0
    for n, s in shapes.items():
        out[n] = (off, tuple(s))
        off += -(-math.prod(s) // align) * align
    return out, off


def _views(buf, layout, names=None):
    """{name: view of ``buf``} of a ``_layout``; with ``names``, the list
    of those names' views."""
    if names is not None:
        return [buf[o:o + math.prod(s)].view(s)
                for o, s in (layout[n] for n in names)]
    return {n: buf[o:o + math.prod(s)].view(s)
            for n, (o, s) in layout.items()}


def _select_(finite, new, old):
    """The guard's select: ``old = new`` where ``finite``, in place."""
    torch.where(finite, new, old, out=old)


class FusedSymbolStep:
    """Forward + backward + update + aux fold of a bound Symbol.

    Owns the fp32 master parameters, the optimizer state, the aux states
    and the learning-rate scalar on ``device`` (by default the current
    context's, ``cuda:0``, which raises without a card) between steps;
    ``params()`` hands them out. They keep their storage for the step's
    life (a captured graph holds their addresses): ``load_params`` copies
    into them. The masters take no gradient themselves; each training forward
    differentiates leaves that alias them."""

    # other threads (a DataPipeline's stager) stay free to call the
    # runtime while a step is captured: see the module docstring
    capture_error_mode = "thread_local"

    def __init__(self, symbol, data_names, label_names, param_names,
                 aux_names, trainable, optimizer, compute_dtype=None,
                 device=None):
        self.symbol = symbol
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.param_names = list(param_names)
        self.aux_names = list(aux_names)
        self.input_names = [n for n in symbol.list_arguments()
                            if n not in set(param_names)]
        self.trainable = dict(trainable)
        self.optimizer = optimizer
        self.compute_dtype = torch_dtype(compute_dtype)
        self.device = as_device(device)
        self._fopt = functional_opt.from_optimizer(optimizer)
        self._lr_mults = {n: optimizer.lr_mult.get(n, 1.0)
                          for n in self.param_names}
        self._wd_eff = {n: optimizer.wd * optimizer.wd_mult.get(n, 1.0)
                        for n in self.param_names}
        self._sparse_sites = []  # routed SparseEmbedding sites (start)
        self._routed = {}        # routed table name -> vocab
        self._set_groups()
        self.pass_report = None
        self._fwd_loss = None
        self._run_arg_names = symbol.list_arguments()
        self._run_aux_names = list(aux_names)
        self._p = self._state = self._aux = None
        self._t = None           # the update count, a 0-dim device int32
        self._gen = None         # sgld's noise generator
        self._leaves = None      # the last training forward's param leaves
        self._lr = None
        # (feed signature, metric slots version) -> CapturedProgram
        self._programs = {}
        self._warm_sigs = set()  # feed signatures that ran their warm step
        self._symbol_sha = None
        self.last_loss = None
        self.num_update = 0
        # the non-finite step guard: decided once, key material
        self.guard_enabled = str(config.get("MXTPU_FT_GUARD")).lower() \
            not in ("0", "false", "off")
        self._max_consec = int(config.get("MXTPU_FT_MAX_CONSEC_SKIPS"))
        self.fault_state = None  # int32[2]: total, consecutive skips
        self._skip_lag = collections.deque()
        # in-step metric slots (attach_metric / metric_device.py)
        self._metric_sigs = []     # per slot: its structural signature
        self._metric_rules = []    # per slot: (label names, pred names, fn)
        self._metric_state = []    # per slot: a 0-dim device counter
        self._metric_owner = []    # per slot: weakref to its metric
        self.metric_detach_epoch = 0
        self._slots_version = 0    # bumped when slots are added or dropped

    def _set_groups(self):
        """Params sharing (lr_mult, wd) update together, laid out side by
        side in the flat buffers: one slice per group for an elementwise
        rule, one foreach launch per operation otherwise. Routed tables
        are in no group."""
        groups = {}
        for n in self.param_names:
            if self.trainable[n] and n not in self._routed:
                groups.setdefault((self._lr_mults[n], self._wd_eff[n]),
                                  []).append(n)
        self._groups = sorted(groups.items())

    @property
    def started(self):
        return self._p is not None

    @property
    def captured(self):
        """True when the step runs as a captured CUDA graph."""
        return self.device.type == "cuda"

    def start(self, arg_dict, aux_dict, input_shapes):
        """Run the ``train``-mode rewrite pipeline on the bound shapes
        (``input_shapes``: {input name: shape}) and take fp32 copies of
        the initial params and aux on the device."""
        from ..symbol import passes as _passes
        shapes = {n: tuple(d[n].shape)
                  for d in (arg_dict, aux_dict) for n in d}
        shapes.update({n: tuple(s) for n, s in input_shapes.items()})
        fused_sym, self.pass_report = _passes.apply_pipeline(
            self.symbol, shapes, tag="fused_step", mode="train",
            device=self.device, compute_dtype=self.compute_dtype,
            data_names=set(self.data_names) | set(self.label_names))
        run_sym = fused_sym if fused_sym is not None else self.symbol
        _, self._fwd_loss, _ = build_graph_fns(run_sym)
        self._run_arg_names = run_sym.list_arguments()
        self._run_aux_names = run_sym.list_auxiliary_states()
        self._find_sparse_sites(run_sym, shapes)
        self.load_params(arg_dict, aux_dict)
        self._init_state()
        self._lr = torch.full((), float(self.optimizer.lr),
                              dtype=torch.float32, device=self.device)
        self._t = torch.zeros((), dtype=torch.int32, device=self.device)
        if self._fopt.needs_key:
            from .. import random as _random
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(_random._seed[0])
        self.fault_state = torch.zeros(2, dtype=torch.int32,
                                       device=self.device)
        self._skip_lag.clear()
        fault.register_guard(self)

    def _find_sparse_sites(self, run_sym, shapes):
        """The row-sparse sites of the rewritten graph (the JAX package's
        detection at ``start``): routed when the rule has a lazy form
        and the table is trainable; tied tables and sites without a lazy
        rule are counted in ``sparse::dense_fallback``."""
        from ..sparse.embedding import find_sites
        from ..telemetry import registry as treg
        tied = []
        sites = find_sites(run_sym, self.param_names, self.input_names,
                           shapes, fallbacks=tied)
        if tied:
            treg.counter("sparse::dense_fallback").inc(len(tied))
        self._sparse_sites = []
        if sites and self._fopt.row_update is None:
            treg.counter("sparse::dense_fallback").inc(len(sites))
        elif sites:
            self._sparse_sites = [s for s in sites
                                  if self.trainable.get(s.weight_name)]
            treg.gauge("sparse::sites").set(len(self._sparse_sites))
        self._routed = {s.weight_name: s.vocab for s in self._sparse_sites}
        self._set_groups()

    def _init_state(self):
        """One flat fp32 buffer per state leaf: a parameter-shaped leaf
        laid out as the masters, a 0-dim one as one element per
        trainable parameter; each filled with the rule's ``init`` of the
        parameter's initial value."""
        names = list(self._p_layout)
        proto = self._fopt.init(torch.empty(0, device="meta"))
        scalar_layout = {n: (i, ()) for i, n in enumerate(names)}
        self._leaf_layouts = [self._p_layout if tuple(x.shape) == (0,)
                              else scalar_layout for x in proto]
        self._flat_state = [
            torch.zeros(self._flat_p.numel() if lay is self._p_layout
                        else len(names), dtype=torch.float32,
                        device=self.device)
            for lay in self._leaf_layouts]
        leaves = [_views(b, lay) for b, lay in
                  zip(self._flat_state, self._leaf_layouts)]
        self._state = {n: tuple(v[n] for v in leaves) for n in names}
        # a routed table's leaves: buffers shaped as the table (trash row
        # included), the real rows exposed
        self._table_state = {
            n: tuple(torch.zeros_like(t) for _ in proto)
            for n, t in self._tables.items()}
        for n, leaves in self._table_state.items():
            self._state[n] = tuple(x[:self._routed[n]] for x in leaves)
        self._fill_state()

    def _fill_state(self):
        with torch.no_grad():
            for n, leaves in self._state.items():
                for dst, x in zip(leaves, self._fopt.init(self._p[n])):
                    dst.copy_(x)

    def reset_state(self):
        """The rule's initial state of the current masters, ``t`` = 0 and
        ``num_update`` = 0, written in place (a captured graph holds the
        buffers)."""
        self._fill_state()
        self._t.zero_()
        self.num_update = 0

    def load_params(self, arg_dict, aux_dict):
        """Set the master params and aux (optimizer state is kept): the
        first call allocates them (the trainable masters and the aux as
        views of one flat buffer each), later ones copy into them in
        place."""
        if self._p is None:
            self._p_layout, size = _layout(
                {n: arg_dict[n].shape for _, ns in self._groups
                 for n in ns}, _ALIGN)
            # a routed table: its own buffer with one trash row past the
            # end (zeros, never written)
            self._tables = {
                n: torch.zeros((v + 1,) + tuple(arg_dict[n].shape[1:]),
                               dtype=torch.float32, device=self.device)
                for n, v in self._routed.items()}
            self._zpad = torch.zeros(_ALIGN, dtype=torch.float32,
                                     device=self.device)
            self._flat_p = torch.zeros(size, dtype=torch.float32,
                                       device=self.device)
            flat = _views(self._flat_p, self._p_layout)
            self._p = {n: flat[n] if n in flat
                       else self._tables[n][:self._routed[n]]
                       if n in self._tables else torch.empty(
                           arg_dict[n].shape, dtype=torch.float32,
                           device=self.device)
                       for n in self.param_names}
            self._aux_layout, size = _layout(
                {n: aux_dict[n].shape for n in self.aux_names}, 1)
            self._flat_aux = torch.zeros(size, dtype=torch.float32,
                                         device=self.device)
            self._aux = _views(self._flat_aux, self._aux_layout)
        with torch.no_grad():
            for n in self.param_names:
                self._p[n].copy_(arg_dict[n].detach())
            for n in self.aux_names:
                self._aux[n].copy_(aux_dict[n].detach())

    def params(self):
        """(arg_params, aux_params): the fp32 masters and aux."""
        return dict(self._p), dict(self._aux)

    def set_lr(self, lr):
        """Write the base learning rate (the schedule's value) into the
        step's device scalar, in stream order before the next step."""
        self._lr.fill_(float(lr))

    def _cast(self, v):
        cdt = self.compute_dtype
        return v.to(cdt) if cdt is not None and v.dtype == torch.float32 \
            else v

    def _inputs(self, feed):
        """{input name: tensor} of ``feed``, where it lies."""
        vals = {}
        for n in self.input_names:
            if n not in feed:
                raise MXNetError(f"fused step missing input '{n}'")
            v = feed[n]
            vals[n] = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(v)
        return vals

    def _on_device(self, vals):
        return {n: v.to(self.device, non_blocking=True)
                for n, v in vals.items()}

    def _values(self, vals, params=None):
        """Graph argument and aux values from device inputs ``vals`` and
        ``params`` (default: the masters). A routed table goes in as it
        is: only its sites read it, and their outputs are preset."""
        params = self._p if params is None else params
        arg_vals = [params[n] if n in self._routed
                    else self._cast(params[n]) if n in params
                    else vals[n] if n in self.label_names
                    else self._cast(vals[n]) for n in self._run_arg_names]
        aux_vals = [self._cast(self._aux[n]) for n in self._run_aux_names]
        return arg_vals, aux_vals

    def _forward_loss(self, vals):
        """The recorded forward. It differentiates fresh leaves that alias
        the masters (``detach``: no copy), made anew each step: autograd
        ties a leaf's gradient accumulator to the stream it was made on,
        and a capture must not reach back to one made by an earlier
        step on another stream."""
        self._leaves = {n: p.detach().requires_grad_(
            self.trainable[n] and n not in self._routed)
            for n, p in self._p.items()}
        preset = self._site_rows(vals)
        with torch.enable_grad():
            arg_vals, aux_vals = self._values(vals, self._leaves)
            loss, (outs, aux_up) = self._fwd_loss(arg_vals, aux_vals,
                                                  preset=preset)
        return loss, outs, aux_up

    def _site_rows(self, vals):
        """Each routed site's gathered rows, a fresh leaf the backward
        differentiates, preset as the site's output (None without
        sites). Ids are taken as the JAX package's gather takes them:
        ``[-V, -1]`` wraps, any other out-of-range id reads the trash
        row and gives a NaN row. ``self._site_ids`` keeps each site's
        normalized flat ids for the dedup."""
        self._site_leaves, self._site_ids = [], []
        if not self._sparse_sites:
            return None
        from ..sparse.rowsparse import _table_index
        preset = {}
        for s in self._sparse_sites:
            ids = vals[s.ids_name]
            idx = _table_index(ids, s.vocab)
            rows = self._tables[s.weight_name].index_select(
                0, idx.reshape(-1)).reshape(tuple(idx.shape) + (s.dim,))
            rows = torch.where((idx < s.vocab).unsqueeze(-1), rows,
                               float("nan"))
            leaf = rows.requires_grad_(True)
            self._site_leaves.append(leaf)
            self._site_ids.append(idx.reshape(-1))
            with torch.enable_grad():
                preset[(id(s.node), 0)] = self._cast(leaf)
        return preset

    def forward_loss(self, feed):
        """The training forward on ``feed``, recorded for the backward:
        ``(loss, outputs, aux_updates)``."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        return self._forward_loss(self._on_device(self._inputs(feed)))

    def backward(self, loss):
        """{param: fp32 gradient} of ``loss`` (params the graph does not
        read, such as fix_gamma's gamma, get zeros, as ``jax.grad``
        gives); a routed table's is a ``sparse.RowSparseRows``: its
        sites' row gradients merged and deduplicated."""
        from ..sparse.rowsparse import dedup_rows
        names = [n for _, ns in self._groups for n in ns]
        grads = torch.autograd.grad(
            loss, [self._leaves[n] for n in names] + self._site_leaves,
            allow_unused=True, materialize_grads=True)
        out = dict(zip(names, grads[:len(names)]))
        merged = {}
        for s, ids, g in zip(self._sparse_sites, self._site_ids,
                             grads[len(names):]):
            merged.setdefault(s.weight_name, []).append(
                (ids, g.reshape(-1, s.dim).float()))
        for n, parts in merged.items():
            ids = torch.cat([p[0] for p in parts])
            g = torch.cat([p[1] for p in parts])
            out[n] = dedup_rows(ids, g, num_rows=self._routed[n])
        return out

    def _update(self, grad, aux_up, finite=None):
        """The optimizer update of the fp32 masters at the device lr
        scalar times each group's lr_mult and the count ``t + 1``, the
        aux fold, and ``t`` advanced. In place; with ``finite`` (a 0-dim
        bool device tensor: the guard's verdict) the new values go to
        scratch buffers laid out as the state, and one select per buffer
        writes them, or keeps the old ones (``t`` advances either way).
        The gradients ``grad`` are the step's own and may be written."""
        with torch.no_grad():
            t1 = self._t + 1
            kw = {"t": t1, "key": self._gen}
            new_aux = torch.cat([
                (aux_up[n] if n in aux_up else self._aux[n]).reshape(-1)
                for n in self.aux_names]).to(torch.float32) \
                if self.aux_names else None
            for n in self._routed:
                self._fopt.row_update_(
                    self._tables[n], grad[n].ids, grad[n].rows,
                    self._table_state[n],
                    self._group_lr(self._lr_mults[n]), self._wd_eff[n],
                    t=t1, finite=finite)
            if finite is None:
                for (lr_mult, wd), ns in self._groups:
                    self._fopt.update_(*self._operands(grad, ns),
                                       self._group_lr(lr_mult), wd,
                                       donate_grads=True, **kw)
                if new_aux is not None:
                    self._flat_aux.copy_(new_aux)
                self._t.copy_(t1)
                return
            new_p = torch.empty_like(self._flat_p)
            new_s = [torch.empty_like(b) for b in self._flat_state]
            for (lr_mult, wd), ns in self._groups:
                self._fopt.update_(
                    *self._operands(grad, ns), self._group_lr(lr_mult), wd,
                    out=self._operands(None, ns, new_p, new_s)[::2],
                    donate_grads=True, **kw)
            _select_(finite, new_p, self._flat_p)
            for new, old in zip(new_s, self._flat_state):
                _select_(finite, new, old)
            if new_aux is not None:
                _select_(finite, new_aux, self._flat_aux)
            self._t.copy_(t1)

    def _group_span(self, ns):
        """(start, end) of the group ``ns`` in the flat buffers when the
        rule is elementwise with parameter-shaped leaves and the group's
        views tile the span in order (padding included), else None. A
        rule written in place (sgd) takes a view per parameter: it makes
        no temporary per operation, so gathering the gradients would
        only add their copy."""
        if not self._fopt.elementwise or self._fopt.inplace is not None \
                or any(lay is not self._p_layout
                       for lay in self._leaf_layouts):
            return None
        start = pos = self._p_layout[ns[0]][0]
        for n in ns:
            off, shape = self._p_layout[n]
            if off != pos:
                return None
            pos = off + -(-math.prod(shape) // _ALIGN) * _ALIGN
        return start, pos

    def _operands(self, grad, ns, flat_p=None, flat_state=None):
        """``update_``'s (params, grads, states) of group ``ns``: one
        slice each of the flat buffers (``flat_p`` / ``flat_state``,
        default the masters and the state) and the gradients gathered
        into one padded buffer when ``_group_span`` allows it, else a
        view per parameter. ``grad`` None leaves the gradients out."""
        span = self._group_span(ns)
        if span is not None:
            flat_p = self._flat_p if flat_p is None else flat_p
            flat_state = self._flat_state if flat_state is None \
                else flat_state
            a, b = span
            gs = None
            if grad is not None:
                pieces = []
                for n in ns:
                    g = grad[n].float().reshape(-1)
                    pieces.append(g)
                    pad = -g.numel() % _ALIGN
                    if pad:
                        pieces.append(self._zpad[:pad])
                gs = [torch.cat(pieces)]
            return [flat_p[a:b]], gs, [tuple(x[a:b] for x in flat_state)]
        gs = None if grad is None else [grad[n].float() for n in ns]
        if flat_p is None:
            return ([self._p[n] for n in ns], gs,
                    [self._state[n] for n in ns])
        pv = _views(flat_p, self._p_layout, ns)
        sv = [_views(x, lay, ns) for x, lay in zip(flat_state,
                                                   self._leaf_layouts)]
        return pv, gs, [tuple(v[i] for v in sv) for i in range(len(ns))]

    def _group_lr(self, lr_mult):
        return self._lr if lr_mult == 1.0 else self._lr * lr_mult

    def _finite(self, grads):
        """The guard's verdict: whether the sum of |g| over every
        gradient (one fp32 scalar; a NaN or Inf anywhere propagates, and
        an overflow of the sum itself is a gradient explosion) is
        finite."""
        norms = torch._foreach_norm(
            [g.rows if n in self._routed else g for n, g in grads.items()],
            1)
        return torch.isfinite(torch.stack(norms).sum())

    def _advance_metrics(self, vals, outs, finite):
        """Advance every attached metric counter on this step's labels
        (``vals``) and outputs, in place (kept on a skipped step)."""
        if not self._metric_rules:
            return
        preds = dict(zip(self.symbol.list_outputs(), outs))
        with torch.no_grad():
            for (lnames, pnames, fn), st in zip(self._metric_rules,
                                                self._metric_state):
                new = fn(st, [vals[n] for n in lnames],
                         [preds[n].detach() for n in pnames])
                if finite is None:
                    st.copy_(new)
                else:
                    _select_(finite, new, st)

    def _advance_fault_state(self, finite):
        """[total skips, consecutive skips] in place."""
        skipped = torch.logical_not(finite).to(torch.int32)
        f = self.fault_state
        f.copy_(torch.stack([f[0] + skipped, (f[1] + 1) * skipped]))

    def apply(self, grad, aux_up, lr=None):
        """The optimizer update of the fp32 masters and the aux fold
        (``lr``, when given, is written into the lr scalar first); it
        consumes ``grad``, whose tensors may be overwritten."""
        if lr is not None:
            self.set_lr(lr)
        self._update(grad, aux_up)
        self.num_update += 1

    def gradients(self, feed):
        """One step's forward and backward without the update: ``(loss,
        {param: fp32 gradient}, aux_updates, outputs)``."""
        loss, outs, aux_up = self.forward_loss(feed)
        return (loss.detach(), self.backward(loss), aux_up,
                [o.detach() for o in outs])

    def _body(self, vals):
        """Forward, backward, the guard, update, aux fold and metric
        counters on device inputs ``vals``: the program a capture
        records. ``(loss, outputs)``."""
        loss, outs, aux_up = self._forward_loss(vals)
        grads = self.backward(loss)
        finite = self._finite(grads) if self.guard_enabled else None
        self._update(grads, aux_up, finite)
        self._advance_metrics(vals, outs, finite)
        if finite is not None:
            self._advance_fault_state(finite)
        return loss.detach(), [o.detach() for o in outs]

    def _sparse_hooks(self, feed, host):
        """Before a step with routed sites: the ``sparse_update`` fault
        site (``step=N``; a raise fails the step before it runs,
        ``action=kill`` is the SIGKILL drill) and the host id
        statistics."""
        if not self._sparse_sites:
            return
        if faultinject.fire("sparse_update", step=self.num_update):
            raise faultinject.FaultInjected("sparse_update",
                                            step=self.num_update)
        from .. import sparse as _sparse
        if _sparse.stats_enabled():
            _sparse.note_step_ids(self._sparse_sites, feed, host)

    def _poisoned(self, vals):
        """The ``nan_grad:step=N`` fault site: the float data inputs of
        step N times NaN, before they reach the step (the same program
        then runs with NaN gradients)."""
        if not faultinject.fire("nan_grad", step=self.num_update):
            return vals
        vals = dict(vals)
        for n in self.data_names:
            if vals[n].is_floating_point():
                vals[n] = vals[n] * float("nan")
        return vals

    def _run_eager(self, vals, lr, check=True):
        if lr is not None:
            self.set_lr(lr)
        loss, outs = self._body(self._on_device(vals))
        self.num_update += 1
        self.last_loss = loss
        if check:
            self._check_abort()
        return outs

    def step_eager(self, feed, lr=None, host=None):
        """One step without a graph: every kernel launched from Python.
        Returns the graph's outputs; the loss stays on the device in
        ``last_loss``. ``host``: a host copy of the feed, read only by
        the sparse id statistics."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        self._sparse_hooks(feed, host)
        return self._run_eager(self._poisoned(self._inputs(feed)), lr)

    def step(self, feed, lr=None, host=None):
        """One training step on ``feed`` ({input name: tensor or array});
        ``lr``, when given, is written into the lr scalar first (the
        caller applies the schedule). On a CUDA device the captured
        program of the feed's signature and the attached metric slots
        (see the module docstring); on the CPU the eager step. Returns
        the graph's outputs (copies); the loss stays on the device in
        ``last_loss``. ``host``: a host copy of the feed, read only by
        the sparse id statistics.

        Step-time attribution (``telemetry.timeline``): inside ``fit``'s
        ``device_step`` phase the step books ``h2d_stage`` (the feed
        into the static buffers), ``compile`` (the warm step and the
        capture at a new signature, and the program's key wherever a
        new one is made), the replay (on the CPU the eager step) under
        ``device_step`` and the abort check under ``metric_ft_sync``;
        nesting subtracts, so nothing counts twice. Without an active
        timeline each phase is one shared no-op. Nothing of it touches
        the card: the phases are host wall time (the replay returns once
        launched)."""
        if not self.started:
            raise MXNetError("FusedSymbolStep used before start()")
        # the straggler drill: 'slow_step:action=sleep:ms=N' stretches
        # every step by N ms
        faultinject.fire("slow_step", step=self.num_update)
        self._sparse_hooks(feed, host)
        tl = _tlmod.current()
        null = _tlmod.null_phase()
        with tl.phase("h2d_stage") if tl else null:
            vals = self._poisoned(self._inputs(feed))
        sig = compile_mod.arg_signature(list(vals.values()))
        pkey = (sig, self._slots_version)
        prog = self._programs.get(pkey)
        if prog is None:
            with tl.phase("compile") if tl else null:
                key = self._program_key(sig)
                compile_mod.note_entry_point(key.name, key, sig)
                prog = self._programs[pkey] = \
                    compile_mod.CapturedProgram(key)
                prog.metric_slots = len(self._metric_sigs)
        if not self.captured:
            with tl.phase("device_step") if tl else null:
                outs = self._run_eager(vals, lr, check=False)
            with tl.phase("metric_ft_sync") if tl else null:
                self._check_abort()
            return outs
        if sig not in self._warm_sigs:
            self._warm_sigs.add(sig)
            with tl.phase("compile") if tl else null:
                return self._warm_step(vals, lr)
        if lr is not None:
            self.set_lr(lr)
        if not prog.captured:
            with tl.phase("compile") if tl else null:
                self._capture(prog, vals)
        with tl.phase("h2d_stage") if tl else null:
            self._load_inputs(prog, vals)
        with tl.phase("device_step") if tl else null:
            prog.replay()
            self.num_update += 1
            loss, outs = prog.outputs
            self.last_loss = loss.clone()
            outs = [o.clone() for o in outs]
        with tl.phase("metric_ft_sync") if tl else null:
            self._check_abort()
        return outs

    def _warm_step(self, vals, lr):
        """The first step at a feed signature: eager, on a side stream."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outs = self._run_eager(vals, lr)
        main.wait_stream(side)
        for t in [self.last_loss] + outs:
            t.record_stream(main)
        return outs

    def _capture(self, prog, vals):
        """Static input buffers for ``vals``'s signature, then the step
        captured over them (nothing runs; the replay computes it)."""
        prog.static = {n: torch.empty(v.shape, dtype=v.dtype,
                                      device=self.device)
                       for n, v in vals.items()}
        try:
            prog.capture(lambda: self._body(prog.static),
                         capture_error_mode=self.capture_error_mode,
                         generators=(self._gen,) if self._gen is not None
                         else (), arguments=self._state_tensors())
        except Exception as e:
            raise MXNetError(f"capturing the fused step "
                             f"{prog.key.name} as a CUDA graph failed: "
                             f"{e}") from e

    def _state_tensors(self):
        """Every tensor the step reads or writes in place besides its
        static inputs (the memory row's arguments)."""
        out = [self._flat_p, self._flat_aux, self._t, self._lr,
               self.fault_state]
        out += list(self._flat_state) + list(self._metric_state)
        out += list(self._p.values()) + list(self._aux.values())
        for leaves in self._table_state.values():
            out += list(leaves)
        return [t for t in out if isinstance(t, torch.Tensor)]

    def _program_of(self, feed):
        """The program of ``feed``'s signature at the current metric
        slots, or None before :meth:`step` acquired it."""
        sig = compile_mod.arg_signature(list(self._inputs(feed).values()))
        return self._programs.get((sig, self._slots_version))

    def step_cost(self, feed):
        """``{}``: the step's cost (flops, bytes accessed) has no source
        here. The JAX package reads it off XLA's cost analysis of the
        compiled step; a CUDA graph of hand-written kernels carries no
        such count, so the port records none and the ``step::flops`` /
        ``step::bytes_accessed`` gauges stay unset: the JAX package's
        own path for a backend without cost analysis."""
        return {}

    def step_memory(self, feed):
        """The memory row recorded when the program of ``feed``'s
        signature was captured (``telemetry.memory``: pool, argument,
        output, temp and peak bytes), or ``{}`` (not captured yet, or
        the CPU). Never captures a second time."""
        prog = self._program_of(feed)
        return dict(prog.memory) if prog is not None else {}

    def _load_inputs(self, prog, vals):
        """Copy the feed into the program's static inputs (stream order:
        before the replay)."""
        for n, v in vals.items():
            prog.static[n].copy_(v, non_blocking=True)

    # -- the guard's lagged abort and its counters ----------------------------
    def _check_abort(self):
        """``MXTPU_FT_MAX_CONSEC_SKIPS=K``: after each step, a copy of
        ``fault_state`` goes to the host behind the step (pinned memory
        and an event on the card; a clone on the CPU); copies are read
        once done, and the one from K steps back is waited for. So the
        step itself never waits, and an abort comes at most K steps
        after the K-th consecutive skip."""
        if self._max_consec <= 0 or not self.guard_enabled:
            return
        if self.device.type == "cuda":
            buf = torch.empty(2, dtype=torch.int32, pin_memory=True)
            buf.copy_(self.fault_state, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._skip_lag.append((ev, buf))
        else:
            self._skip_lag.append((None, self.fault_state.clone()))
        while self._skip_lag:
            ev, buf = self._skip_lag[0]
            if ev is not None and not ev.query():
                if len(self._skip_lag) <= self._max_consec:
                    break
                ev.synchronize()
            self._skip_lag.popleft()
            consec = int(buf[1])
            if consec >= self._max_consec:
                fault.count("guard.aborts")
                raise MXNetError(
                    f"aborting training: {consec} consecutive non-finite "
                    f"steps were skipped by the gradient guard "
                    f"(MXTPU_FT_MAX_CONSEC_SKIPS={self._max_consec}); the "
                    "model state predates the first skipped step: inspect "
                    "the data and loss scale and resume from the last "
                    "checkpoint")

    def reset_fault_state(self):
        """Zero the device skip counters in place
        (``fault_report(reset=True)``)."""
        if self.fault_state is None:
            return
        self.fault_state.zero_()
        self._skip_lag.clear()

    # -- in-step metrics (metric_device.py) ------------------------------------
    @property
    def num_metric_slots(self):
        return len(self._metric_state)

    def metric_state(self, idx):
        """Slot ``idx``'s device counter."""
        return self._metric_state[idx]

    def attach_metric(self, metric, sig, dtype, lnames, pnames, fn):
        """Claim an in-step counter slot for ``metric``: a 0-dim ``dtype``
        counter on the device that ``fn`` advances inside the step. A
        slot with the same signature whose owner died (or is this metric)
        is reused, its counter zeroed in place: no new capture. Otherwise
        a slot is added, and the next step captures anew. Returns the
        slot's index."""
        for i, s in enumerate(self._metric_sigs):
            owner = self._metric_owner[i]
            o = owner() if owner is not None else None
            if s == sig and (o is None or o is metric):
                self._metric_owner[i] = weakref.ref(metric)
                self._metric_state[i].zero_()
                return i
        self._metric_sigs.append(sig)
        self._metric_rules.append((list(lnames), list(pnames), fn))
        self._metric_state.append(torch.zeros((), dtype=dtype,
                                              device=self.device))
        self._metric_owner.append(weakref.ref(metric))
        self._slots_version += 1
        return len(self._metric_sigs) - 1

    def live_metrics(self):
        """The attached metrics still alive."""
        out = []
        for wr in self._metric_owner:
            m = wr() if wr is not None else None
            if m is not None:
                out.append(m)
        return out

    def detach_metrics(self):
        """Drop every counter rule (their shapes went stale;
        ``metric_device`` folds the live windows first). The programs
        captured with slots go too: their graphs hold the counters."""
        if not self._metric_rules:
            return
        self._metric_sigs = []
        self._metric_rules = []
        self._metric_state = []
        self._metric_owner = []
        self.metric_detach_epoch += 1
        self._slots_version += 1
        self._programs = {k: p for k, p in self._programs.items()
                          if p.metric_slots == 0}

    def release_metric_slot(self, idx):
        """Disown one slot (its metric went back to the host path); the
        rule keeps running until the slot is reused."""
        if idx < len(self._metric_owner):
            self._metric_owner[idx] = None

    def reset_metric_state(self, idx):
        """Zero slot ``idx``'s counter in place."""
        if idx < len(self._metric_state):
            self._metric_state[idx].zero_()

    # -- optimizer state io ----------------------------------------------------
    def states_snapshot(self):
        """The optimizer state as the JAX package's fused step serializes
        it, unpickled: ``{"__mxnet_tpu_fused__": 1, "optimizer",
        "num_update", "state": {param: (numpy leaves)}}`` (a fixed param
        has no leaves). The device reads are ordered after the last step
        on the current stream."""
        leaves = [(n, x) for n in self.param_names
                  for x in self._state.get(n, ())]
        host = host_numpy([x for _, x in leaves])
        state = {n: () for n in self.param_names}
        for (n, _), h in zip(leaves, host):
            state[n] += (h,)
        return {"__mxnet_tpu_fused__": 1,
                "optimizer": type(self.optimizer).__name__.lower(),
                "num_update": self.num_update, "state": state}

    def get_states(self):
        """``states_snapshot()`` pickled: the bytes of a ``.states``
        file."""
        return pickle.dumps(self.states_snapshot())

    def set_states(self, data):
        """Load ``get_states``' bytes (or the JAX package's): each leaf
        is copied into the momentum it belongs to, in place."""
        obj = pickle.loads(data) if isinstance(data, (bytes, bytearray)) \
            else data
        if not (isinstance(obj, dict) and obj.get("__mxnet_tpu_fused__")):
            raise MXNetError(
                "optimizer states were saved by the eager Updater path; "
                "the fused Module step cannot load them")
        if not self.started:
            raise MXNetError("call after bind/init (start() not run)")
        saved_opt = obj.get("optimizer")
        cur_opt = type(self.optimizer).__name__.lower()
        if saved_opt is not None and saved_opt != cur_opt:
            raise MXNetError(
                f"optimizer states were saved for '{saved_opt}' but the "
                f"module now runs '{cur_opt}'")
        with torch.no_grad():
            for n in self.param_names:
                saved = obj["state"].get(n)
                cur = self._state.get(n, ())
                if saved is None:
                    continue
                if len(saved) != len(cur):
                    raise MXNetError(
                        f"saved optimizer state for '{n}' has {len(saved)} "
                        f"leaves, expected {len(cur)}: optimizer mismatch?")
                for s, c in zip(saved, cur):
                    c.copy_(torch.from_numpy(np.array(s, np.float32))
                            .reshape(c.shape))
        self.num_update = int(obj["num_update"])
        self._t.fill_(self.num_update)

    def staging_sharding(self):
        """Where ``fit``'s data pipeline stages batches: the step's
        device."""
        return self.device

    def _program_key(self, sig):
        """The step program's key at one feed signature (the JAX
        package's materials, ``mxnet_tpu/module/fused.py``
        ``_program_key``: the guard flag, the metric slots' signatures
        and the routed sparse sites among them, less the mesh ones this
        port lacks)."""
        from ..symbol import passes as _passes
        if self._symbol_sha is None:
            self._symbol_sha = compile_mod.symbol_digest(self.symbol)
        fusion_report = _passes.legacy_fusion_entry(self.pass_report)
        fusion = {"flag": str(config.get("MXTPU_PALLAS_FUSION")),
                  "sites": len(fusion_report["sites"])
                  if fusion_report else 0}
        extra = {"guard": bool(self.guard_enabled),
                 "compute_dtype": str(self.compute_dtype).replace(
                     "torch.", ""),
                 "trainable": sorted((n, bool(v))
                                     for n, v in self.trainable.items()),
                 "metrics": repr(tuple(self._metric_sigs)),
                 "sparse": [s.describe() for s in self._sparse_sites]}
        return compile_mod.program_key(
            "fused_step", f"fused_step:{self.symbol.name}",
            symbol_sha=self._symbol_sha, input_sigs=sig,
            optimizer=self.optimizer, fusion=fusion,
            passes=_passes.pipeline_key_material(self.pass_report),
            extra=extra, device=self.device)
