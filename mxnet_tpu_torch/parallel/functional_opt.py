"""Functional optimizer rules (counterpart of
``mxnet_tpu/parallel/functional_opt.py``): every rule of the JAX
package — sgd, nag, lbsgd, lars, adam, adamax, nadam, ftml, adagrad,
rmsprop, adadelta, ftrl, signsgd, signum, sgld, dcasgd and test.

``create(name, **kwargs)`` / ``from_optimizer(opt)`` return a rule with

    init(param)                             -> state tuple (fp32 leaves)
    update(param, grad, state, lr, t, wd, key=None) -> (new_param, new_state)
    update_(params, grads, states, lr, wd, out=None, t=1, key=None)

Each rule's arithmetic is written once, over lists of tensors
(``_V``: one ``torch._foreach_*`` launch per operation for a whole list),
in the JAX rule's order of operations. ``update`` runs it on a list of
one tensor and is pure; ``update_`` runs it on lists and writes the new
values into ``params`` and ``states`` in place, or, with
``out=(new_params, new_states)`` (lists shaped as ``params`` and
``states``), into ``out``, leaving ``params`` and ``states`` as they were.
Both forms write the same values, bit for bit (the fused step's guard
selects ``out`` into the state). sgd, the training step's main path, is
written in place instead (``inplace``: the scaled gradient in one
scratch list, or in the gradients themselves when the caller donates
them, then the momentum and the params updated where they lie);
``update`` runs it on clones and ``update_`` with ``out=`` on copies,
so the same rules hold. Only donated gradients are written.

State leaves are parameter-shaped or 0-dim (nadam's ``m_schedule``); sgd
without momentum, signsgd, signum without momentum and sgld have none.

``lr`` is a Python float (the eager paths) or a 0-dim fp32 tensor on the
parameters' device (the fused step, whose captured CUDA graph reads it at
every replay). ``t`` is the 1-based update count: a Python int (eager
paths) or a 0-dim integer device tensor (the captured step advances it on
the device, so a replay never reuses a count baked in at capture). The
rules that read it (adam, adamax, nadam, ftml, lbsgd's schedules) take it
in fp32 on the device, as the JAX rules take their traced count: an int
becomes that tensor first, so both forms give the same values. ``key``
is sgld's noise source, a ``torch.Generator`` on the parameters' device
(the device's generator of ``random.generator`` when None); a captured
step registers its generator with the graph. Momentum, betas, wd and the
other hyperparameters stay constants of the rule.

sgd and adam also have a lazy row-sparse rule (``lazy_update``, True by
default; ``row_supported()``), the JAX package's ``row_update``: only the
rows a batch touched advance (weight decay on touch, the momentum and
moments of untouched rows frozen, Adam's bias correction from the global
count ``t``). It runs the dense rule's own body on the gathered rows, so
at full coverage it is the dense update bit for bit:

    row_update(p, uids, rows, state, lr, t, wd)  -> (new_p, new_state)
    row_update_(table, ids, rows, state, lr, wd, t=1, finite=None)

``row_update_`` updates in place a table that carries one trash row past
its ``V`` real rows, and its state leaves laid out the same; ``ids`` lie
in ``[0, V]``, the sentinel ``V`` naming the trash row. The touched rows
are gathered, the body runs on them, and a sentinel slot (or every slot,
when the 0-dim bool ``finite`` is False: the fused step's guard) writes
back what it read, so the trash row and a skipped step's rows never
change. ``row_update`` is the pure form over a ``(V, dim)`` table: it
appends the trash row to copies and runs ``row_update_`` on them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["FunctionalOptimizer", "create", "from_optimizer", "supported",
           "row_supported"]

# test hook: sgld's noise is multiplied by this (0 leaves the rule's
# deterministic part, which tests hold against the JAX rule exactly)
sgld_noise_scale = 1.0


class _V:
    """A list of tensors with elementwise arithmetic by foreach ops.
    Operands: another ``_V`` (per-tensor, 0-dim leaves broadcast), a
    Python number or a 0-dim tensor (the same scalar for every tensor)."""

    __slots__ = ("ts",)

    def __init__(self, ts):
        self.ts = list(ts)

    @staticmethod
    def _other(o):
        return o.ts if isinstance(o, _V) else o

    def __add__(self, o):
        return _V(torch._foreach_add(self.ts, self._other(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return _V(torch._foreach_sub(self.ts, self._other(o)))

    def __rsub__(self, o):
        return _V(torch._foreach_add(torch._foreach_neg(self.ts), o))

    def __mul__(self, o):
        return _V(torch._foreach_mul(self.ts, self._other(o)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _V(torch._foreach_div(self.ts, self._other(o)))

    def __neg__(self):
        return _V(torch._foreach_neg(self.ts))

    def sqrt(self):
        return _V(torch._foreach_sqrt(self.ts))

    def square(self):
        return self * self

    def abs(self):
        return _V(torch._foreach_abs(self.ts))

    def sign(self):
        return _V(torch._foreach_sign(self.ts))

    def maximum(self, o):
        return _V(torch._foreach_maximum(self.ts, self._other(o)))

    def clip(self, lo, hi):
        return _V(torch._foreach_clamp_max(
            torch._foreach_clamp_min(self.ts, lo), hi))

    def norms(self):
        """The per-tensor 2-norms, as a ``_V`` of 0-dim tensors."""
        return _V(torch._foreach_norm(self.ts))


def _f32(x):
    """fp32 of a tensor; a number stays as it is."""
    return x.float() if isinstance(x, torch.Tensor) else x


def _tf(t, ref):
    """The update count as a 0-dim fp32 tensor on ``ref``'s device."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return torch.tensor(float(t), dtype=torch.float32, device=ref.device)


def _pow(base, tf):
    return torch.pow(base, tf)


class FunctionalOptimizer:
    """A pure optimizer rule: closures over static hyperparameters.

    ``elementwise``: the update is per element given (lr, wd), so a flat
    concatenation of parameters updates exactly (the per-tensor-norm
    rules, lbsgd/lars with ``warmup_strategy='lars'``, are not);
    ``needs_key``: the rule draws noise (sgld); ``lazy``: the rule has a
    lazy row-sparse form (``row_update`` is None otherwise)."""

    def __init__(self, name, init_fn, body=None, needs_key=False,
                 elementwise=True, inplace=None, lazy=False):
        self.name = name
        self.init = init_fn
        self.row_update = self._row_update if lazy else None
        self._body = body      # (P, G, [leaf _V], lr, t, wd, key) -> ...
        # or, for a rule written in place (sgd): (params, grads,
        # [leaf lists], lr, wd, donate) -> None, grads written only when
        # donated
        self.inplace = inplace
        self.needs_key = needs_key
        self.elementwise = elementwise

    def update(self, p, g, s, lr, t, wd=0.0, key=None):
        """The pure per-tensor form: ``(new_param, new_state)``."""
        if self.inplace is not None:
            new_p, new_s = p.clone(), tuple(x.clone() for x in s)
            self.inplace([new_p], [_f32(g)], [[x] for x in new_s],
                         _f32(lr), wd)
            return new_p, new_s
        new_p, new_s = self._body(_V([p]), _V([_f32(g)]),
                                  [_V([x]) for x in s], _f32(lr), t, wd,
                                  key)
        return new_p.ts[0], tuple(v.ts[0] for v in new_s)

    def update_(self, params, grads, states, lr, wd=0.0, out=None, t=1,
                key=None, donate_grads=False):
        """The list form over ``params`` (fp32), their ``grads`` and
        ``states`` (one state tuple per param), with one ``lr`` and
        ``wd``: in place, or into ``out`` (see the module docstring).
        ``donate_grads``: the caller gives up ``grads`` (temporaries of
        its own), and a rule written in place scales them where they lie
        instead of in a scratch list."""
        if not params:
            return
        n_leaves = len(states[0]) if states else 0
        if self.inplace is not None:
            if out is not None:
                # the same operations, in the same order, on copies
                torch._foreach_copy_(list(out[0]), list(params))
                for j in range(n_leaves):
                    torch._foreach_copy_([s[j] for s in out[1]],
                                         [s[j] for s in states])
                params, states = out
            self.inplace(list(params), [_f32(g) for g in grads],
                         [[s[j] for s in states] for j in range(n_leaves)],
                         _f32(lr), wd, donate_grads)
            return
        leaves = [_V([s[j] for s in states]) for j in range(n_leaves)]
        new_p, new_s = self._body(_V(params), _V([_f32(g) for g in grads]),
                                  leaves, _f32(lr), t, wd, key)
        dst_p, dst_s = (params, states) if out is None else out
        torch._foreach_copy_(list(dst_p), new_p.ts)
        for j, v in enumerate(new_s):
            torch._foreach_copy_([s[j] for s in dst_s], v.ts)


    def row_update_(self, table, ids, rows, state, lr, wd=0.0, t=1,
                    finite=None):
        """The lazy row rule in place (see the module docstring): the
        rows of ``table`` (fp32, ``(V + 1, dim)``, row ``V`` the trash
        row) and of its ``state`` leaves named by ``ids`` (int64
        ``(capacity,)`` in ``[0, V]``) take one update from their summed
        gradient ``rows``; sentinel slots, and all slots when ``finite``
        is False, write back the rows they read."""
        if self.row_update is None:
            raise ValueError(f"optimizer '{self.name}' has no lazy row "
                             "rule")
        trash = table.shape[0] - 1
        old_p = table.index_select(0, ids)
        old_s = tuple(x.index_select(0, ids) for x in state)
        new_p = torch.empty_like(old_p)
        new_s = tuple(torch.empty_like(x) for x in old_s)
        self.update_([old_p], [rows], [old_s], lr, wd,
                     out=([new_p], [new_s]), t=t)
        keep = (ids == trash).unsqueeze(-1)
        if finite is not None:
            keep = keep | torch.logical_not(finite)
        table.index_copy_(0, ids, torch.where(keep, old_p, new_p))
        for x, o, n in zip(state, old_s, new_s):
            x.index_copy_(0, ids, torch.where(keep, o, n))

    def _row_update(self, p, uids, rows, s, lr, t, wd=0.0):
        """The pure lazy row rule over a ``(V, dim)`` table ``p``:
        ``(new_p, new_state)``; ``uids`` as ``dedup_rows`` gives them
        (sorted, the sentinel ``V`` at the tail)."""
        from ..sparse.rowsparse import _table_index
        v = p.shape[0]
        ids = _table_index(uids, v)
        pad = p.new_zeros((1,) + tuple(p.shape[1:]))
        table = torch.cat([p, pad])
        state = tuple(torch.cat([x, torch.zeros_like(pad, dtype=x.dtype)])
                      for x in s)
        self.row_update_(table, ids, _f32(rows), state, _f32(lr), wd, t=t)
        return table[:v], tuple(x[:v] for x in state)


_FACTORIES = {}


def _factory(*names):
    def deco(fn):
        for n in names:
            _FACTORIES[n] = fn
        return fn
    return deco


def supported():
    return sorted(_FACTORIES)


def row_supported():
    """Optimizer names with a lazy row-sparse rule."""
    return sorted(n for n in _FACTORIES
                  if create(n).row_update is not None)


_COMMON_KEYS = {"rescale_grad", "clip_gradient"}
_PARAM_KEYS = {
    "sgd": {"momentum", "lazy_update"},
    "nag": {"momentum"},
    "lbsgd": {"momentum", "eta", "warmup_strategy", "warmup_epochs",
              "updates_per_epoch", "batch_scale", "begin_epoch",
              "num_epochs", "multi_precision"},
    "lars": {"momentum", "eta", "warmup_strategy", "warmup_epochs",
             "updates_per_epoch", "batch_scale"},
    "adam": {"beta1", "beta2", "epsilon", "lazy_update"},
    "adamax": {"beta1", "beta2"},
    "nadam": {"beta1", "beta2", "epsilon", "schedule_decay"},
    "ftml": {"beta1", "beta2", "epsilon"},
    "adagrad": {"eps"},
    "rmsprop": {"gamma1", "gamma2", "epsilon", "centered", "clip_weights"},
    "adadelta": {"rho", "epsilon"},
    "ftrl": {"lamda1", "beta"},
    "signsgd": set(),
    "signum": {"momentum", "wd_lh"},
    "sgld": set(),
    "dcasgd": {"momentum", "lamda"},
    "test": set(),
}


def create(name, **kwargs):
    name = name.lower()
    if name not in _FACTORIES:
        raise ValueError(
            f"no functional rule for optimizer '{name}'; supported: "
            f"{supported()}")
    unknown = set(kwargs) - _PARAM_KEYS[name] - _COMMON_KEYS
    if unknown:
        raise TypeError(
            f"optimizer '{name}' got unexpected parameters {sorted(unknown)}"
            f"; accepted: {sorted(_PARAM_KEYS[name] | _COMMON_KEYS)}")
    return _FACTORIES[name](kwargs)


def _g32(g, kw):
    """Common gradient preprocessing: rescale, clip."""
    g = g * kw.get("rescale_grad", 1.0)
    clip = kw.get("clip_gradient")
    if clip is not None and clip > 0:
        g = g.clip(-clip, clip)
    return g


def _g32_wd_then_clip(g, p, kw, wd):
    """Weight decay folded in before the clip (adamax, nadam, ftml)."""
    g = g * kw.get("rescale_grad", 1.0) + wd * p
    clip = kw.get("clip_gradient")
    if clip is not None and clip > 0:
        g = g.clip(-clip, clip)
    return g


def _zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


# -- sgd / nag / lbsgd --------------------------------------------------------

@_factory("sgd")
def _make_sgd(kw):
    momentum = kw.get("momentum", 0.0)

    def init(p):
        return (_zeros(p),) if momentum else ()

    rescale = float(kw.get("rescale_grad", 1.0))
    clip = kw.get("clip_gradient")
    clip = float(clip) if clip is not None and clip > 0 else None

    def inplace(params, grads, leaves, lr, wd, donate=False):
        # step = lr * (clip(rescale * g) + wd * p), then the momentum and
        # the params in place: the training step's update on its main
        # path, with no temporary per operation. Each operation works in
        # place on the donated gradients; otherwise the first one writes
        # a scratch list, and the caller's gradients stay as they were.
        step = grads if donate else None

        def scale(op, *args, **kw):
            nonlocal step
            if step is None:
                step = getattr(torch, op)(grads, *args, **kw)
            else:
                getattr(torch, op + "_")(step, *args, **kw)

        if rescale != 1.0:
            scale("_foreach_mul", rescale)
        if clip is not None:
            scale("_foreach_clamp_min", -clip)
            scale("_foreach_clamp_max", clip)
        if wd:
            scale("_foreach_add", params, alpha=float(wd))
        scale("_foreach_mul", lr)
        if momentum:
            (moms,) = leaves
            torch._foreach_mul_(moms, float(momentum))
            torch._foreach_sub_(moms, step)
            torch._foreach_add_(params, moms)
        else:
            torch._foreach_sub_(params, step)

    return FunctionalOptimizer("sgd", init, inplace=inplace,
                               lazy=kw.get("lazy_update", True))


@_factory("nag")
def _make_nag(kw):
    momentum = kw.get("momentum", 0.0)

    def init(p):
        return (_zeros(p),)

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw) + wd * p
        (mom,) = s
        mom = momentum * mom + g
        return p - lr * (g + momentum * mom), (mom,)

    return FunctionalOptimizer("nag", init, body)


@_factory("lbsgd")
def _make_lbsgd(kw):
    """Large-batch SGD; ``warmup_strategy='lars'`` takes the trust ratio
    from per-tensor norms (``_foreach_norm``: one norm per parameter, not
    one of a whole buffer)."""
    momentum = kw.get("momentum", 0.9)
    eta = kw.get("eta", 1.0)
    strategy = kw.get("warmup_strategy", "linear")
    warmup_epochs = kw.get("warmup_epochs", 5)
    updates_per_epoch = kw.get("updates_per_epoch", 32)
    batch_scale = float(kw.get("batch_scale", 1))

    def init(p):
        return (_zeros(p),)

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        if strategy == "lars":
            w_norm, g_norm = p.norms(), g.norms()
            mult = _V([torch.where((w > 0) & (gn > 0),
                                   eta * w / (gn + wd * w + 1e-9), 1.0)
                       for w, gn in zip(w_norm.ts, g_norm.ts)])
        else:
            nwup = float(warmup_epochs * updates_per_epoch)
            nup = _tf(t, p.ts[0])
            if nwup <= 1:
                mult = torch.full_like(nup, batch_scale)
            elif strategy == "linear":
                mult = 1.0 + (batch_scale - 1) * nup / nwup
            elif strategy == "power2":
                mult = 1.0 + (batch_scale - 1) * (nup * nup) / (nwup * nwup)
            elif strategy == "sqrt":
                mult = 1.0 + (batch_scale - 1) * torch.sqrt(nup / nwup)
            else:
                mult = torch.ones_like(nup)
            mult = torch.clamp_max(mult, batch_scale)
        lr = mult * lr
        (mom,) = s
        mom = momentum * mom + lr * (g + wd * p)
        return p - mom, (mom,)

    return FunctionalOptimizer("lbsgd", init, body,
                               elementwise=(strategy != "lars"))


@_factory("lars")
def _make_lars(kw):
    """LBSGD with trust-ratio warmup and eta = 0.001."""
    kw = dict(kw)
    kw.setdefault("warmup_strategy", "lars")
    kw.setdefault("eta", 0.001)
    return _make_lbsgd(kw)


# -- adam family --------------------------------------------------------------

@_factory("adam")
def _make_adam(kw):
    beta1 = kw.get("beta1", 0.9)
    beta2 = kw.get("beta2", 0.999)
    epsilon = kw.get("epsilon", 1e-8)

    def init(p):
        return (_zeros(p), _zeros(p))

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw) + wd * p
        mean, var = s
        mean = beta1 * mean + (1 - beta1) * g
        var = beta2 * var + (1 - beta2) * g.square()
        tf = _tf(t, p.ts[0])
        lr_t = lr * torch.sqrt(1 - _pow(beta2, tf)) / (1 - _pow(beta1, tf))
        return p - lr_t * mean / (var.sqrt() + epsilon), (mean, var)

    return FunctionalOptimizer("adam", init, body,
                               lazy=kw.get("lazy_update", True))


@_factory("adamax")
def _make_adamax(kw):
    beta1 = kw.get("beta1", 0.9)
    beta2 = kw.get("beta2", 0.999)

    def init(p):
        return (_zeros(p), _zeros(p))

    def body(p, g, s, lr, t, wd, key):
        g = _g32_wd_then_clip(g, p, kw, wd)
        m, u = s
        m = beta1 * m + (1 - beta1) * g
        u = (beta2 * u).maximum(g.abs())
        lr_t = lr / (1 - _pow(beta1, _tf(t, p.ts[0])))
        return p - lr_t * m / (u + 1e-8), (m, u)

    return FunctionalOptimizer("adamax", init, body)


@_factory("nadam")
def _make_nadam(kw):
    beta1 = kw.get("beta1", 0.9)
    beta2 = kw.get("beta2", 0.999)
    epsilon = kw.get("epsilon", 1e-8)
    decay = kw.get("schedule_decay", 0.004)

    def init(p):
        # m_schedule is carried as a 0-dim leaf (the eager class keeps it
        # in Python, which cannot live across captured steps)
        return (_zeros(p), _zeros(p),
                torch.ones((), dtype=torch.float32, device=p.device))

    def body(p, g, s, lr, t, wd, key):
        g = _g32_wd_then_clip(g, p, kw, wd)
        m, v, m_sched = s
        tf = _tf(t, p.ts[0])
        mom_t = beta1 * (1.0 - 0.5 * _pow(0.96, tf * decay))
        mom_t1 = beta1 * (1.0 - 0.5 * _pow(0.96, (tf + 1) * decay))
        m_sched = m_sched * mom_t
        m_sched_next = m_sched * mom_t1
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g.square()
        g_prime = g / (1 - m_sched)
        m_prime = m / (1 - m_sched_next)
        v_prime = v / (1 - _pow(beta2, tf))
        m_bar = (1 - mom_t) * g_prime + mom_t1 * m_prime
        return p - lr * m_bar / (v_prime.sqrt() + epsilon), (m, v, m_sched)

    return FunctionalOptimizer("nadam", init, body)


@_factory("ftml")
def _make_ftml(kw):
    beta1 = kw.get("beta1", 0.6)
    beta2 = kw.get("beta2", 0.999)
    epsilon = kw.get("epsilon", 1e-8)

    def init(p):
        return (_zeros(p), _zeros(p), _zeros(p))

    def body(p, g, s, lr, t, wd, key):
        g = _g32_wd_then_clip(g, p, kw, wd)
        d, v, z = s
        tf = _tf(t, p.ts[0])
        v = beta2 * v + (1 - beta2) * g.square()
        d_new = (1 - _pow(beta1, tf)) / lr * (
            (v / (1 - _pow(beta2, tf))).sqrt() + epsilon)
        sigma = d_new - beta1 * d
        z = beta1 * z + (1 - beta1) * g - sigma * p
        return -z / d_new, (d_new, v, z)

    return FunctionalOptimizer("ftml", init, body)


# -- adaptive-rate family -----------------------------------------------------

@_factory("adagrad")
def _make_adagrad(kw):
    eps = kw.get("eps", 1e-7)

    def init(p):
        return (_zeros(p),)

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        (h,) = s
        h = h + g.square()
        return p - lr * (g / (h + eps).sqrt() + wd * p), (h,)

    return FunctionalOptimizer("adagrad", init, body)


@_factory("rmsprop")
def _make_rmsprop(kw):
    gamma1 = kw.get("gamma1", 0.9)
    gamma2 = kw.get("gamma2", 0.9)
    epsilon = kw.get("epsilon", 1e-8)
    centered = kw.get("centered", False)
    clip_weights = kw.get("clip_weights")

    def init(p):
        return (_zeros(p), _zeros(p), _zeros(p)) if centered else (_zeros(p),)

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw) + wd * p
        if not centered:
            (n,) = s
            n = gamma1 * n + (1 - gamma1) * g.square()
            w = p - lr * g / (n + epsilon).sqrt()
            st = (n,)
        else:
            n, gbar, delta = s
            n = gamma1 * n + (1 - gamma1) * g.square()
            gbar = gamma1 * gbar + (1 - gamma1) * g
            delta = gamma2 * delta - lr * g / (
                n - gbar.square() + epsilon).sqrt()
            w = p + delta
            st = (n, gbar, delta)
        if clip_weights is not None and clip_weights > 0:
            w = w.clip(-clip_weights, clip_weights)
        return w, st

    return FunctionalOptimizer("rmsprop", init, body)


@_factory("adadelta")
def _make_adadelta(kw):
    rho = kw.get("rho", 0.90)
    epsilon = kw.get("epsilon", 1e-5)

    def init(p):
        return (_zeros(p), _zeros(p))

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        acc_g, acc_d = s
        acc_g = rho * acc_g + (1 - rho) * g.square()
        cur = (acc_d + epsilon).sqrt() / (acc_g + epsilon).sqrt() * g
        acc_d = rho * acc_d + (1 - rho) * cur.square()
        return p - cur - wd * p, (acc_g, acc_d)

    return FunctionalOptimizer("adadelta", init, body)


@_factory("ftrl")
def _make_ftrl(kw):
    lamda1 = kw.get("lamda1", 0.01)
    beta = kw.get("beta", 1.0)

    def init(p):
        return (_zeros(p), _zeros(p))

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        z, n = s
        n_new = n + g.square()
        sigma = (n_new.sqrt() - n.sqrt()) / lr
        z = z + g - sigma * p
        val = (z.sign() * lamda1 - z) / ((beta + n_new.sqrt()) / lr + wd)
        w = _V([torch.where(zz.abs() <= lamda1, torch.zeros_like(vv), vv)
                for zz, vv in zip(z.ts, val.ts)])
        return w, (z, n_new)

    return FunctionalOptimizer("ftrl", init, body)


# -- sign / noise / delay-compensated family ----------------------------------

@_factory("signsgd")
def _make_signsgd(kw):
    def init(p):
        return ()

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        return p - lr * (g.sign() + wd * p), ()

    return FunctionalOptimizer("signsgd", init, body)


@_factory("signum")
def _make_signum(kw):
    momentum = kw.get("momentum", 0.9)
    wd_lh = kw.get("wd_lh", 0.0)

    def init(p):
        return (_zeros(p),) if momentum != 0.0 else ()

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        if momentum == 0.0:
            return p - lr * (g.sign() + wd * p), ()
        (mom,) = s
        mom = momentum * mom - (1 - momentum) * (g + wd * p)
        return (1 - lr * wd_lh) * p + lr * mom.sign(), (mom,)

    return FunctionalOptimizer("signum", init, body)


@_factory("sgld")
def _make_sgld(kw):
    def init(p):
        return ()

    def body(p, g, s, lr, t, wd, key):
        from .. import random as _random
        g = _g32(g, kw)
        gen = key if key is not None else _random.generator(p.ts[0].device)
        noise = _V([torch.randn(x.shape, generator=gen, dtype=torch.float32,
                                device=x.device) for x in p.ts])
        scale = torch.sqrt(lr) if isinstance(lr, torch.Tensor) \
            else math.sqrt(lr)
        noise = noise * (scale * sgld_noise_scale)
        return p - lr / 2 * (g + wd * p) + noise, ()

    return FunctionalOptimizer("sgld", init, body, needs_key=True)


@_factory("dcasgd")
def _make_dcasgd(kw):
    """Delay-compensated async SGD; in a synchronous step the delay is
    zero, but the variance-control term is kept for parity with the
    eager class."""
    momentum = kw.get("momentum", 0.0)
    lamda = kw.get("lamda", 0.04)

    def init(p):
        return (_zeros(p), p.detach().to(torch.float32, copy=True))

    def body(p, g, s, lr, t, wd, key):
        g = _g32(g, kw)
        mom, prev_w = s
        mon = g + wd * p + lamda * g * g * (p - prev_w)
        mom = momentum * mom - lr * mon
        # the previous weight is the pre-update weight
        return p + mom, (mom, p * 1.0)

    return FunctionalOptimizer("dcasgd", init, body)


@_factory("test")
def _make_test(kw):
    def init(p):
        return (_zeros(p),)

    def body(p, g, s, lr, t, wd, key):
        w = p - _g32(g, kw)
        return w, (w,)

    return FunctionalOptimizer("test", init, body)


# -- bridging from eager Optimizer objects ------------------------------------

# attributes each eager class carries, by its registered (lowercase) name;
# every entry also takes rescale_grad / clip_gradient from the base class
_ATTR_MAP = {
    "sgd": ("momentum", "lazy_update"),
    "nag": ("momentum",),
    "lbsgd": ("momentum", "warmup_strategy", "warmup_epochs",
              "updates_per_epoch", "batch_scale"),
    "adam": ("beta1", "beta2", "epsilon", "lazy_update"),
    "adamax": ("beta1", "beta2"),
    "nadam": ("beta1", "beta2", "epsilon", "schedule_decay"),
    "ftml": ("beta1", "beta2", "epsilon"),
    "adagrad": (),
    "rmsprop": ("gamma1", "gamma2", "epsilon", "centered", "clip_weights"),
    "adadelta": ("rho", "epsilon"),
    "ftrl": ("lamda1", "beta"),
    "signsgd": (),
    "signum": ("momentum", "wd_lh"),
    "sgld": (),
    "dcasgd": ("momentum", "lamda"),
    "test": (),
}


def from_optimizer(opt):
    """The functional rule of an ``Optimizer`` instance, hyperparameters
    read off it; lr and wd stay per call so the caller applies the
    schedule and the per-parameter multipliers."""
    name = type(opt).__name__.lower()
    if name not in _ATTR_MAP:
        raise ValueError(
            f"no functional rule for optimizer class {type(opt).__name__}; "
            f"supported: {supported()}")
    kw = {a: getattr(opt, a) for a in _ATTR_MAP[name] if hasattr(opt, a)}
    if name == "adagrad":
        kw["eps"] = getattr(opt, "float_stable_eps", 1e-7)
    kw["rescale_grad"] = getattr(opt, "rescale_grad", 1.0)
    kw["clip_gradient"] = getattr(opt, "clip_gradient", None)
    return create(name, **kw)
