"""Pass manager: the ordered rewrite pipeline (counterpart of
``mxnet_tpu/symbol/passes/manager.py``).

It runs the ported passes in the JAX package's order and returns the
same report shape: one entry per pass with ``flag``, ``status``
(``applied`` / ``no_match`` / ``disabled`` / ``inapplicable`` /
``skipped`` / ``rejected`` / ``error``), ``reason``, ``sites`` and
``bailouts``. A pass's ``precheck`` skips it on a graph it has nothing
to do in (the LM's embedding graph: ``embedding_graph``).

Ungated in this slice: the JAX manager rejects a pass that does not
strictly reduce XLA cost-analysis bytes (``MXTPU_PASS_GATE_BYTES``).
PyTorch has no counterpart of that measurement yet, so every enabled
pass that matches is applied, and the ``bytes_*`` fields stay None.
``bn_fold``, ``hoist``, ``int8_ptq`` and ``bf16_cast`` are not ported
yet; each is listed as ``disabled`` with that reason.

A pass that raises, or whose rewrite is rejected, is recorded as
``error`` / ``rejected`` and the graph stays as it was — except for a
CUDA program, where that graph would run library ops in place of the
kernels the pass was to substitute: there the manager raises
``MXNetError`` instead.
"""
from __future__ import annotations

from ...base import MXNetError
from .base import PassContext, flag_active

__all__ = ["PassManager", "default_manager", "apply_pipeline",
           "pipeline_key_material", "legacy_fusion_entry", "NOT_PORTED"]

NOT_PORTED = ("bn_fold", "hoist", "int8_ptq", "bf16_cast")


class PassManager:
    """An ordered pipeline of :class:`GraphPass` instances."""

    def __init__(self, passes, not_ported=NOT_PORTED):
        self.passes = list(passes)
        self.not_ported = tuple(not_ported)

    def run(self, sym, shapes, *, tag, mode="serving", device=None,
            compute_dtype=None, data_names=None):
        """Run the pipeline over ``sym``; ``shapes`` maps every argument
        and aux name to its bound shape, ``device`` resolves ``auto``
        flags. Returns ``(final_sym | None, report)`` — None means no
        pass applied and callers keep the original graph."""
        shapes = {n: tuple(s) for n, s in shapes.items()}
        ctx = PassContext(tag=tag, mode=mode, device=device,
                          compute_dtype=compute_dtype, shapes=shapes,
                          data_names=data_names)
        report = {"tag": tag, "mode": mode, "passes": [],
                  "baseline_bytes": None, "final_bytes": None}
        cur, changed = sym, False
        for p in self.passes:
            flag = p.resolve()
            entry = {"pass": p.name, "flag": flag, "status": "?",
                     "reason": None, "sites": [], "bailouts": [],
                     "bytes_before": None, "bytes_after": None,
                     "bytes_delta": None}
            report["passes"].append(entry)
            if not flag_active(flag, device):
                entry["status"] = "disabled"
                continue
            if mode not in p.modes:
                entry["status"] = "inapplicable"
                entry["reason"] = f"mode:{mode}"
                continue
            ctx.symbol = cur
            reason = p.precheck(ctx)
            if reason:
                entry["status"] = "skipped"
                entry["reason"] = reason
                continue
            try:
                new_sym, prep = p.apply(cur, shapes, ctx)
            except Exception as e:  # noqa: BLE001 - off CUDA a broken
                _fail(p, device, repr(e), e)   # pass must not break the
                entry["status"] = "error"      # bind; the report carries
                entry["reason"] = repr(e)      # the error
                continue
            entry["sites"] = list(prep.get("sites", ()))
            entry["bailouts"] = list(prep.get("bailouts", ()))
            if new_sym is None or not entry["sites"]:
                entry["status"] = "no_match"
                continue
            if (set(new_sym.list_arguments()) != set(cur.list_arguments())
                    or set(new_sym.list_auxiliary_states())
                    != set(cur.list_auxiliary_states())):
                reason = "rewrite changed the argument/aux name set"
                _fail(p, device, reason)
                entry["status"] = "rejected"
                entry["reason"] = reason
                continue
            entry["status"] = "applied"
            cur, changed = new_sym, True
        for name in self.not_ported:
            report["passes"].append({
                "pass": name, "flag": "off", "status": "disabled",
                "reason": "not ported to mxnet_tpu_torch yet", "sites": [],
                "bailouts": [], "bytes_before": None, "bytes_after": None,
                "bytes_delta": None})
        return (cur if changed else None), report


def _fail(p, device, reason, cause=None):
    """Raise when a pass failed for a CUDA program (see the module
    docstring); return otherwise."""
    if device is not None and device.type == "cuda":
        raise MXNetError(f"rewrite pass {p.name} failed for a program on "
                         f"{device}: {reason}") from cause


def default_manager():
    """The pipeline in the JAX package's order: BN(+ReLU)→1×1-conv
    fusion, then residual-chain fusion."""
    from .pallas_fusion import PallasFusionPass
    from .residual_fusion import ResidualFusionPass
    return PassManager([PallasFusionPass(), ResidualFusionPass()])


def apply_pipeline(sym, shapes, *, tag, mode="serving", device=None,
                   compute_dtype=None, data_names=None):
    """Run the default pipeline over a bound symbol."""
    return default_manager().run(sym, shapes, tag=tag, mode=mode,
                                 device=device, compute_dtype=compute_dtype,
                                 data_names=data_names)


def pipeline_key_material(report):
    """The pipeline's contribution to a program's key: per pass (name,
    resolved flag, status, rewritten-site count). Two builds that
    resolved the pipeline differently are different programs."""
    if not report:
        return None
    return [(e["pass"], e["flag"], e.get("status"),
             len(e.get("sites") or ()))
            for e in report["passes"]]


def legacy_fusion_entry(report):
    """The pallas-fusion slice of a pipeline report in the JAX package's
    ``fusion_report`` shape ({tag, sites, bailouts}); None when the pass
    was disabled."""
    if not report:
        return None
    for e in report["passes"]:
        if e["pass"] != "pallas_fusion":
            continue
        if e["status"] == "disabled":
            return None
        out = {"tag": report["tag"], "sites": list(e["sites"]),
               "bailouts": list(e["bailouts"])}
        if e["status"] == "rejected":
            out["bailouts"] = out["bailouts"] + [{
                "conv": None, "bn": None,
                "reason": f"rewrite rejected: {e['reason']}"}]
            out["sites"] = []
        return out
    return None
