"""In-step metric counters for the fused Module path (counterpart of
``mxnet_tpu/metric_device.py``).

``fit`` calls ``update_metric`` every batch. The host path
(``metric.py``) copies the step's outputs to the host, which waits for
the card after every step: on a captured step it puts the host's
per-step work back on the critical path. So for the supported metrics
the counters are computed inside the step itself: ``update_metric``
attaches counter rules to the ``FusedSymbolStep`` (one new capture),
each step advances one 0-dim device tensor per metric as part of the
captured program, and the host reads a counter only when the metric is
read (``EvalMetric.get()``: at the Speedometer interval and the epoch
log). Instance counts come from the step count (batch shapes are
static), so a reset at any point realigns exactly.

Each rule reproduces its metric's update (``metric.py``) on device
tensors: ``_b_accuracy``, ``_b_top_k``, ``_b_cross_entropy`` (also
NegativeLogLikelihood), ``_b_elementwise_err`` (MAE, MSE, RMSE) and
``_b_loss``. Top-k ties go to the lower class index, as ``lax.top_k``
orders them in the JAX package; the host path's ``numpy.argsort`` may
order tied scores otherwise. Any other metric takes the host path.

The per-call contract of :func:`inline_update`: contiguous calls (one
per step) stay attached; a second call for the same batch folds the
window, releases the slot and counts the batch again on the host; a gap
(steps that ran without a call) discards the window, which cannot be
attributed; a change of the label or prediction shapes settles the
window the same way and moves the metric to a new slot.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import metric as metric_mod

__all__ = ["inline_update", "flush", "discard", "flush_and_detach"]


def _spec(v):
    """A shape-and-dtype template (a meta tensor) of an array."""
    t = getattr(v, "_data", v)
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


class _DevRef:
    """A leaf metric's view of its in-step counter slot.

    Holds a weakref to the FusedSymbolStep (a metric that outlives its
    Module must not keep the step's buffers alive) and ``seen_t``, the
    step count at the metric's last call, to enforce the per-call
    contract."""

    __slots__ = ("fused_wr", "idx", "inst_per_step", "t0", "last_val",
                 "last_t", "seen_t", "shape_sig", "detach_epoch")

    def __init__(self, fused, idx, inst_per_step, shape_sig):
        self.fused_wr = weakref.ref(fused)
        self.idx = idx
        self.inst_per_step = inst_per_step
        self.shape_sig = shape_sig
        self.detach_epoch = fused.metric_detach_epoch
        # the counter accumulates from the next step on
        self.t0 = fused.num_update
        self.last_val = 0
        self.last_t = fused.num_update
        self.seen_t = fused.num_update

    @property
    def fused(self):
        return self.fused_wr()

    def valid(self, fused):
        f = self.fused
        return (f is not None and f is fused and
                self.detach_epoch == fused.metric_detach_epoch)

    def flush(self, metric):
        """Fold the counter's increase since the last read into the
        metric: one read of the device scalar."""
        f = self.fused
        if f is None or not self.valid(f) or \
                self.idx >= f.num_metric_slots:
            return
        cur_t = f.num_update
        if cur_t == self.last_t:
            return
        cur = f.metric_state(self.idx).item()
        metric.sum_metric += cur - self.last_val
        metric.num_inst += (cur_t - self.last_t) * self.inst_per_step
        self.last_val = cur
        self.last_t = cur_t

    def discard(self):
        """Zero the device counter and realign (``metric.reset()``)."""
        f = self.fused
        if f is None:
            return
        if self.valid(f):
            f.reset_metric_state(self.idx)
        self.last_val = 0
        self.last_t = self.t0 = self.seen_t = f.num_update


def flush_and_detach(fused):
    """Fold every live metric's counters, then drop the step's counter
    rules, so the next attach builds them for new shapes: for a caller
    that changes the batch shapes before the next step runs (the JAX
    package's ``Module.reshape``; the port's Module has no reshape)."""
    for m in fused.live_metrics():
        ref = getattr(m, "_dev_acc", None)
        if ref is not None and ref.valid(fused):
            ref.flush(m)
        m._dev_acc = None
    fused.detach_metrics()


def flush(metric):
    ref = getattr(metric, "_dev_acc", None)
    if ref is not None:
        ref.flush(metric)


def discard(metric):
    ref = getattr(metric, "_dev_acc", None)
    if ref is not None:
        ref.discard()


# -- rule builders ------------------------------------------------------------
# each: build(metric, label templates, pred templates) ->
#   (counter dtype, fn(state, label_vals, pred_vals) -> new state,
#    instances per step), or None when the metric or shapes are not
# supported. label_vals / pred_vals are the step's own tensors, picked
# as EvalMetric.update_dict picks them.

def _pairs_ok(labels, preds):
    return len(labels) == len(preds) and labels


def _b_accuracy(metric, labels, preds):
    if not _pairs_ok(labels, preds):
        return None
    axis = metric.axis
    plan = []
    inst = 0
    for lv, pv in zip(labels, preds):
        need_argmax = pv.ndim > lv.ndim or (pv.ndim == lv.ndim and
                                            pv.shape != lv.shape)
        n = int(np.prod(lv.shape)) if lv.ndim else 1
        pexp = int(np.prod(pv.shape[:axis] + pv.shape[axis + 1:])) \
            if need_argmax else int(np.prod(pv.shape))
        if n != pexp:
            return None
        plan.append(need_argmax)
        inst += n

    def fn(state, label_vals, pred_vals):
        for need_argmax, lab, prd in zip(plan, label_vals, pred_vals):
            p = torch.argmax(prd, dim=axis) if need_argmax else prd
            hits = p.to(torch.int32).reshape(-1) == \
                lab.to(torch.int32).reshape(-1)
            state = state + hits.sum().to(torch.int32)
        return state

    return torch.int32, fn, inst


def top_k_hits(prd, lab, k):
    """Per row: whether ``lab`` is among the ``k`` largest scores of
    ``prd`` (rows, classes), ties going to the lower class index as
    ``lax.top_k`` orders them. Exact and sort-free: the label's rank is
    the count of larger scores plus the count of equal scores at lower
    indices."""
    x = prd.float()
    c = x.shape[1]
    li = lab.reshape(-1).long()
    ok = (li >= 0) & (li < c)
    xl = torch.gather(x, 1, li.clamp(0, c - 1)[:, None])
    cols = torch.arange(c, device=x.device)[None, :]
    rank = (x > xl).sum(1) + ((x == xl) & (cols < li[:, None])).sum(1)
    return ok & (rank < k)


def _b_top_k(metric, labels, preds):
    if not _pairs_ok(labels, preds):
        return None
    k = metric.top_k
    inst = 0
    for lv, pv in zip(labels, preds):
        if pv.ndim != 2 or lv.ndim != 1 or pv.shape[0] != lv.shape[0]:
            return None
        inst += int(lv.shape[0])

    def fn(state, label_vals, pred_vals):
        for lab, prd in zip(label_vals, pred_vals):
            hit = top_k_hits(prd, lab, min(k, prd.shape[1]))
            state = state + hit.sum().to(torch.int32)
        return state

    return torch.int32, fn, inst


def _b_cross_entropy(metric, labels, preds):
    if not _pairs_ok(labels, preds):
        return None
    eps = metric.eps
    inst = 0
    for lv, pv in zip(labels, preds):
        if pv.ndim != 2 or int(np.prod(lv.shape)) != pv.shape[0]:
            return None
        inst += int(pv.shape[0])

    def fn(state, label_vals, pred_vals):
        for lab, prd in zip(label_vals, pred_vals):
            li = lab.reshape(-1).long().clamp(0, prd.shape[1] - 1)
            prob = torch.gather(prd.float(), 1, li[:, None])[:, 0]
            state = state + torch.sum(-torch.log(prob + eps))
        return state

    return torch.float32, fn, inst


def _b_elementwise_err(kind):
    def build(metric, labels, preds):
        if not _pairs_ok(labels, preds):
            return None
        shapes = []
        for lv, pv in zip(labels, preds):
            ls = tuple(lv.shape) if lv.ndim > 1 else (
                (lv.shape[0], 1) if lv.ndim else (1, 1))
            ps = tuple(pv.shape) if pv.ndim > 1 else (
                (pv.shape[0], 1) if pv.ndim else (1, 1))
            if ls != ps:
                return None
            shapes.append(ls)

        def fn(state, label_vals, pred_vals):
            for ls, lab, prd in zip(shapes, label_vals, pred_vals):
                d = lab.float().reshape(ls) - prd.float().reshape(ls)
                if kind == "mae":
                    e = torch.mean(torch.abs(d))
                elif kind == "mse":
                    e = torch.mean(torch.square(d))
                else:
                    e = torch.sqrt(torch.mean(torch.square(d)))
                state = state + e
            return state

        return torch.float32, fn, len(shapes)
    return build


def _b_loss(metric, labels, preds):
    inst = sum(int(np.prod(pv.shape)) if pv.ndim else 1 for pv in preds)

    def fn(state, label_vals, pred_vals):
        for prd in pred_vals:
            state = state + torch.sum(prd.float())
        return state

    return torch.float32, fn, inst


_RULES = {
    metric_mod.Accuracy: _b_accuracy,
    metric_mod.TopKAccuracy: _b_top_k,
    metric_mod.CrossEntropy: _b_cross_entropy,
    metric_mod.NegativeLogLikelihood: _b_cross_entropy,
    metric_mod.MAE: _b_elementwise_err("mae"),
    metric_mod.MSE: _b_elementwise_err("mse"),
    metric_mod.RMSE: _b_elementwise_err("rmse"),
    metric_mod.Loss: _b_loss,
}


def _walk(metric, label_dict, pred_dict, out):
    """(leaf, label_dict, pred_dict) triples, the composite's name
    filters applied as ``CompositeEvalMetric.update_dict`` applies them;
    None when some leaf has no rule."""
    if type(metric) is metric_mod.CompositeEvalMetric:
        labels, preds = label_dict, pred_dict
        if metric.label_names is not None:
            labels = {k: v for k, v in labels.items()
                      if k in metric.label_names}
        if metric.output_names is not None:
            preds = {k: v for k, v in preds.items()
                     if k in metric.output_names}
        for m in metric.metrics:
            if _walk(m, labels, preds, out) is None:
                return None
        return out
    if type(metric) not in _RULES:
        return None
    out.append((metric, label_dict, pred_dict))
    return out


def _select(d, override):
    keys = override if override is not None else list(d)
    if any(n not in d for n in keys):
        return None, None
    return [d[n] for n in keys], keys


def inline_update(fused, metric, label_dict, pred_dict) -> bool:
    """``update_metric`` through in-step counters. False when the metric
    is not supported (the caller takes the host path). The batch whose
    step already ran when the rules are attached is counted on the host,
    once; every later step counts on the device. Several metric objects
    take a slot each."""
    leaves = _walk(metric, label_dict, pred_dict, [])
    if leaves is None:
        return False
    plans = []
    for m, ld, pd in leaves:
        pvals, pnames = _select(pd, m.output_names)
        lvals, lnames = _select(ld, m.label_names)
        if pvals is None or lvals is None:
            return False
        lt = [_spec(v) for v in lvals]
        pt = [_spec(v) for v in pvals]
        shape_sig = (tuple(tuple(t.shape) for t in lt),
                     tuple(tuple(t.shape) for t in pt))
        plans.append((m, lnames, pnames, lt, pt, shape_sig))
    refs = [getattr(p[0], "_dev_acc", None) for p in plans]
    if all(r is not None and r.valid(fused) and r.shape_sig == p[5]
           for r, p in zip(refs, plans)):
        if all(fused.num_update == r.seen_t + 1 for r in refs):
            for r in refs:
                r.seen_t = fused.num_update
            return True
        # settle each leaf under its own contract (a composite can mix
        # them when one leaf was also updated alone this batch)
        for r, (m, ld, pd) in zip(refs, leaves):
            if fused.num_update == r.seen_t + 1:
                # contiguous: the counter holds this batch
                r.seen_t = fused.num_update
            elif fused.num_update == r.seen_t:
                # a second call for the same batch: fold the window,
                # release the slot and count the batch again
                r.flush(m)
                fused.release_metric_slot(r.idx)
                m._dev_acc = None
                m.update_dict(ld, pd)
            else:
                # a gap: the counter holds steps whose batches were
                # never submitted; drop the window, count this batch
                r.discard()
                fused.release_metric_slot(r.idx)
                m._dev_acc = None
                m.update_dict(ld, pd)
        return True
    # a partly attached plan (a leaf joins a composite) or a leaf whose
    # label or prediction shapes changed: settle the still-valid windows
    # under the same contract before re-slotting; a contiguous window
    # covers this batch (the step already ran), so its leaf skips the
    # host update below. A leaf with new shapes leaves its old slot
    # (released) for a new one.
    covered = set()
    for r, p in zip(refs, plans):
        if r is not None and r.valid(fused):
            if fused.num_update == r.seen_t + 1:
                r.flush(p[0])
                covered.add(id(p[0]))
            elif fused.num_update == r.seen_t:
                r.flush(p[0])
            else:
                r.discard()
            if r.shape_sig != p[5]:
                fused.release_metric_slot(r.idx)
            p[0]._dev_acc = None
    # build every rule before claiming a slot: a late failure must not
    # leave a partly attached plan (host and device would both count)
    built_rules = []
    for m, lnames, pnames, lt, pt, shape_sig in plans:
        built = _RULES[type(m)](m, lt, pt)
        if built is None:
            return False
        dtype, fn, inst = built
        sig = (type(m).__name__, tuple(lnames), tuple(pnames), shape_sig,
               getattr(m, "axis", None), getattr(m, "top_k", None),
               getattr(m, "eps", None))
        built_rules.append((m, sig, dtype, lnames, pnames, fn, inst,
                            shape_sig))
    for m, sig, dtype, lnames, pnames, fn, inst, shape_sig in built_rules:
        idx = fused.attach_metric(m, sig, dtype, lnames, pnames, fn)
        m._dev_acc = _DevRef(fused, idx, inst, shape_sig)
    # the step already run for this batch is not in the new counters:
    # count it on the host, per leaf, unless a folded window covered it
    for m, ld, pd in leaves:
        if id(m) not in covered:
            m.update_dict(ld, pd)
    return True
