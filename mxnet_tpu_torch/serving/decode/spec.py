"""Speculative decoding: a draft transformer proposes, the target
verifies (counterpart of ``mxnet_tpu/serving/decode/spec.py``).

Each plain decode step moves the whole model and KV-cache to emit one
token a lane. :class:`SpecDecodePredictor` amortizes that: a small draft
model (fewer layers and heads, :func:`make_draft_spec`) proposes up to
``k`` tokens a lane, and the target checks all of them in ONE verify
program of width ``k+1`` (``model.verify_step``; the width is key
material like a prefill bucket, captured at ``warmup()``).

Accept-prefix semantics keep the stream BIT-IDENTICAL to solo greedy
decode: feeding ``[last, d_1..d_k]`` yields the target's argmax after
each fed token, so ``out[0]`` is what the plain decode step would emit;
draft ``d_j`` is accepted iff it equals ``out[j-1]``, and the first
disagreement emits the target's own token. Every round commits 1..k+1
tokens of the greedy stream: the draft's quality moves throughput, never
output. Rejected drafts' cache rows go stale behind the committed
position (``seek_slot``).

Plain lanes ride the same verify launch with a width-1 feed; a
divergence storm (windowed acceptance below ``MXTPU_SPEC_DISABLE_BELOW``,
or the ``spec_verify`` fault site) drops to plain decode for
``MXTPU_SPEC_PROBE_STEPS`` rounds, then probes again.

:func:`distill_draft` trains a draft on the target's own greedy
rollouts through ``Module.fit``, on the target's device.

The windowed figures are also the registry gauges
``serving::<id>::accepted_per_step`` and ``::acceptance_rate``
(``report()["spec"]`` has them all).
"""
from __future__ import annotations

import collections
import threading

import numpy as np

from ... import config
from ...base import MXNetError
from .engine import DecodePredictor
from .model import TransformerLMSpec, build_symbol

__all__ = ["SpecDecodePredictor", "make_draft_spec", "distill_draft"]

# a degrade decision needs this many speculative rounds of evidence in
# the window before the rate is trusted (one unlucky round is not a
# storm)
_MIN_DECIDE_ROUNDS = 8


def make_draft_spec(spec, num_layers=1, shrink=2, name=None):
    """A draft-sized sibling of ``spec``: same vocab and ``max_seq``
    (the draft must address every position the target can), embed and
    heads divided by ``shrink`` (head_dim is preserved: ``d/h`` is
    invariant under dividing both), ``num_layers`` layers. The point is
    a model whose decode step moves genuinely fewer bytes — a draft as
    big as the target can never win bytes-per-accepted-token no matter
    how often it is right."""
    if spec.num_heads % shrink or spec.num_embed % shrink:
        raise MXNetError(
            f"shrink={shrink} must divide num_heads={spec.num_heads} "
            f"and num_embed={spec.num_embed}")
    return TransformerLMSpec(
        vocab_size=spec.vocab_size,
        num_embed=spec.num_embed // shrink,
        num_heads=spec.num_heads // shrink,
        num_layers=int(num_layers),
        max_seq=spec.max_seq,
        name=name or f"{spec.name}-draft")


def distill_draft(target, draft_spec, prompts=None, rollout=40,
                  seq_len=16, num_epoch=8, batch_size=16, lr=3e-3,
                  seed=0):
    """Train ``draft_spec`` weights to imitate ``target``'s greedy
    rollouts: distillation on the distribution speculation pays for (the
    target's own argmax stream, not held-out text).

    ``target`` is a :class:`DecodePredictor`; its solo ``generate``
    produces the training stream, cut into the JAX package's windows
    (``seq_len`` tokens and their successors, every offset). The draft
    trains with Adam and Xavier through ``Module.fit`` on
    ``target.device`` (the JAX package trains on its CPU context; the
    port's entry points run on the card). Returns the trained parameter
    dict (fp32 tensors on that device), ready for
    :class:`SpecDecodePredictor`.
    """
    from ... import initializer, io, metric, module
    rs = np.random.RandomState(seed)
    if prompts is None:
        prompts = [rs.randint(target.spec.vocab_size,
                              size=n).astype(np.int32)
                   for n in (4, 6, 8, 5, 7, 3)]
    seqs = []
    for p in prompts:
        p = np.asarray(p, np.int32)
        lim = target.gen_limit(p.shape[0], rollout)
        toks = list(p) + list(target.generate(p, max_new_tokens=lim))
        seqs.append(np.asarray(toks, np.int32))
    ids = np.concatenate(seqs)
    n = len(ids) - seq_len - 1
    if n < batch_size:
        raise MXNetError(
            f"distill_draft: only {n} training windows from the "
            f"rollouts; lower seq_len/batch_size or raise rollout")
    data = np.stack([ids[i:i + seq_len] for i in range(n)])
    label = np.stack([ids[i + 1:i + seq_len + 1]
                      for i in range(n)]).astype(np.float32)
    train_iter = io.NDArrayIter(data.astype(np.float32), label,
                                batch_size, shuffle=True,
                                last_batch_handle="discard")
    mod = module.Module(symbol=build_symbol(draft_spec, seq_len),
                        data_names=("data",),
                        label_names=("softmax_label",),
                        context=target.device)
    mod.fit(train_iter, num_epoch=num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": lr},
            initializer=initializer.Xavier(),
            eval_metric=metric.Accuracy(axis=2, name="distill_acc"))
    arg_params, _aux = mod.get_params()
    return {k: v.detach().clone() for k, v in arg_params.items()}


class SpecDecodePredictor(DecodePredictor):
    """A :class:`DecodePredictor` whose lanes advance up to ``k+1``
    tokens per round through draft-then-verify.

    Parameters beyond the base class:

    draft_spec, draft_params :
        The proposal model (same vocab/max_seq; see
        :func:`make_draft_spec`). It runs as
        its own ``DecodePredictor`` with the SAME slot count — lane
        ``i`` of the draft mirrors lane ``i`` of the target, so join/
        leave bookkeeping is one slot id.
    k : int, optional
        Speculation depth — drafts proposed per lane per round
        (default ``MXTPU_SPEC_K``). The single verify width ``k+1``
        is declared in ``verify_widths`` so warmup materializes it and
        serving performs zero fresh verify traces.
    draft_kv_dtype : str
        Draft cache dtype (default float32 — the draft cache is small;
        its layout never fingerprints into the target's handoff).
    disable_below / probe_steps / window :
        Degrade policy knobs (defaults ``MXTPU_SPEC_DISABLE_BELOW``,
        ``MXTPU_SPEC_PROBE_STEPS``, ``MXTPU_SPEC_WINDOW``): when the
        windowed acceptance rate over ``window`` speculative rounds
        drops below ``disable_below``, speculation turns OFF for
        ``probe_steps`` rounds (plain decode program — true
        degradation, not width-1 verify), then probes again.
    """

    def __init__(self, spec, params, draft_spec, draft_params, k=None,
                 slots=None, seq_buckets=None, name=None, kv_dtype=None,
                 draft_kv_dtype="float32", disable_below=None,
                 probe_steps=None, window=None, device=None):
        if draft_spec.vocab_size != spec.vocab_size:
            raise MXNetError(
                f"draft vocab {draft_spec.vocab_size} != target vocab "
                f"{spec.vocab_size}")
        if draft_spec.max_seq < spec.max_seq:
            raise MXNetError(
                f"draft max_seq {draft_spec.max_seq} < target max_seq "
                f"{spec.max_seq} — the draft must reach every position")
        super().__init__(spec, params, slots=slots,
                         seq_buckets=seq_buckets, name=name,
                         kv_dtype=kv_dtype, device=device)
        self.spec_k = int(k) if k is not None \
            else int(config.get("MXTPU_SPEC_K"))
        if self.spec_k < 1:
            raise MXNetError(f"speculation depth k={self.spec_k} "
                             "must be >= 1")
        self.verify_widths = (self.spec_k + 1,)
        self.disable_below = float(disable_below) \
            if disable_below is not None \
            else float(config.get("MXTPU_SPEC_DISABLE_BELOW"))
        self.probe_steps = int(probe_steps) if probe_steps is not None \
            else int(config.get("MXTPU_SPEC_PROBE_STEPS"))
        window = int(window) if window is not None \
            else int(config.get("MXTPU_SPEC_WINDOW"))
        self.draft = DecodePredictor(
            draft_spec, draft_params, slots=self.slots,
            seq_buckets=self.buckets, name=f"{self.name}-draft",
            kv_dtype=draft_kv_dtype, device=self.device)
        self._spec_lock = threading.Lock()
        self._spec_rounds = 0        # every spec_step call
        self._plain_until = 0        # degrade: rounds <= this are plain
        self._degrade_events = 0
        self._win = collections.deque(maxlen=window)
        # cumulative over VERIFY rounds (the measured-bytes surfaces)
        self._emit_verify = 0        # tokens committed by verify rounds
        self._lane_rounds = 0        # lane participations in verify
        self._drafts_offered = 0
        self._drafts_accepted = 0
        # per-slot (pos, token) rows the DRAFT cache is missing — the
        # full-accept hole (the k-th draft is proposed but its own K/V
        # row is never written) and any tokens committed by plain
        # rounds; replayed through the draft before the next rollout so
        # proposal quality doesn't decay with stream length. Bounded:
        # beyond maxlen the oldest rows stay stale (quality-only).
        self._draft_backlog = [
            collections.deque(maxlen=2 * (self.spec_k + 1))
            for _ in range(self.slots)]
        from ...telemetry import registry as treg
        pid = self.telemetry_id
        self._aps_g = treg.gauge(f"serving::{pid}::accepted_per_step")
        self._rate_g = treg.gauge(f"serving::{pid}::acceptance_rate")

    # -- lifecycle ------------------------------------------------------------
    def prefill(self, slot, prompt):
        """Prefill BOTH engines' lane ``slot`` (one admission path for
        target and draft keeps their caches position-consistent);
        returns the target's token #1 — the draft's is discarded, it
        only seeds the draft cache."""
        tok = super().prefill(slot, prompt)
        self.draft.prefill(slot, prompt)
        self._draft_backlog[slot].clear()
        return tok

    def warmup(self):
        self.draft.warmup()
        return super().warmup()

    def import_lane(self, slot, lane, prompt=None):
        """Adopt a handed-off TARGET lane; the draft cache (not part of
        the transfer — it is proposal state, reconstructible) is
        re-prefilled from the prompt when given, else left stale with
        positions aligned (quality-only: stale draft context lowers
        acceptance, never correctness)."""
        super().import_lane(slot, lane)
        if prompt is not None:
            self.draft.prefill(slot, prompt)
        self.draft.seek_slot(slot, int(lane["pos"]))
        self._draft_backlog[slot].clear()

    # -- the speculative round ------------------------------------------------
    def spec_step(self, lanes):
        """Advance every lane one ROUND: ``{slot: (last_token, budget,
        speculative)}`` -> ``{slot: [token, ...]}`` with 1..k+1 tokens
        per lane, every token exactly what solo greedy decode would
        stream. ``budget`` caps tokens this lane may still emit (the
        generation's remaining limit); ``speculative=False`` lanes ride
        the same launch with a width-1 feed.

        One round = (optional) draft rollout of up to k small-model
        steps + ONE target verify launch; commit via ``seek_slot`` on
        both engines. Degraded rounds (windowed acceptance below the
        disable threshold, or every lane plain) use the plain decode
        program instead. The ``spec_verify`` fault site fires per
        speculative round (``round`` ordinal): a hit simulates a
        divergence storm — proposals are replaced with deliberately
        wrong tokens, the verify path runs for real, acceptance goes to
        zero, the stream stays exact."""
        if not lanes:
            return {}
        from ... import faultinject
        with self._spec_lock:
            self._spec_rounds += 1
            ordinal = self._spec_rounds
            speculating = ordinal > self._plain_until
        vocab = self.spec.vocab_size
        bases = {s: self.slot_pos(s) for s in lanes}
        depths = {}
        for slot, (last, budget, want_spec) in lanes.items():
            nd = min(self.spec_k, int(budget) - 1,
                     self.spec.max_seq - bases[slot] - 1)
            if speculating and want_spec and nd > 0:
                depths[slot] = nd

        storm = False
        if depths:
            storm = faultinject.fire("spec_verify", round=ordinal)

        proposals = {s: [] for s in lanes}
        if depths and not storm:
            self._draft_sync(depths)
            cur = {s: int(lanes[s][0]) for s in depths}
            for s in depths:
                self.draft.seek_slot(s, bases[s])
            for step in range(max(depths.values())):
                live = {s: cur[s] for s, nd in depths.items()
                        if step < nd}
                if not live:
                    break
                nxt = self.draft.decode(live)
                for s, t in nxt.items():
                    proposals[s].append(int(t))
                    cur[s] = int(t)
        elif depths:
            # storm: keep the verify path honest — feed proposals that
            # are (near-)guaranteed wrong instead of skipping the
            # launch, so "never corrupts a stream" is exercised, not
            # assumed. (An accidental match is still the greedy token —
            # accept-prefix is unconditionally exact.)
            for s, nd in depths.items():
                last = int(lanes[s][0])
                proposals[s] = [(last + 1 + j) % vocab
                                for j in range(nd)]

        if not depths:
            # every lane plain this round: true degradation — the
            # PLAIN decode program (advances positions + counters
            # itself)
            out = {s: [int(t)] for s, t in self.decode(
                {s: int(lanes[s][0]) for s in lanes}).items()}
            self._note_round(out, offered=0, accepted=0,
                             verify_round=False)
            return out

        feed = {s: [int(lanes[s][0])] + proposals[s] for s in lanes}
        res = self.verify(feed)
        out, offered, accepted = {}, 0, 0
        for s, fed in feed.items():
            o = res[s]
            emitted = [int(o[0])]
            for j in range(1, len(fed)):
                if fed[j] != int(o[j - 1]):
                    break
                emitted.append(int(o[j]))
            offered += len(fed) - 1
            accepted += len(emitted) - 1
            out[s] = emitted
            m = len(emitted)
            self.seek_slot(s, bases[s] + m)
            self.draft.seek_slot(s, bases[s] + m)
            # rows the draft rollout did NOT validly write for this
            # lane's newly committed positions (position base+i holds
            # the token fed there: ``last`` at i=0, emitted[i-1] after)
            nd_written = len(proposals[s]) if s in depths \
                and not storm else 0
            toks = [int(lanes[s][0])] + emitted[:-1]
            for i in range(min(nd_written, m), m):
                self._draft_backlog[s].append((bases[s] + i, toks[i]))
        ntok = sum(len(v) for v in out.values())
        with self._lock:
            self._tokens += ntok
            self._tokens_c.inc(ntok)
        self._note_round(out, offered, accepted, verify_round=True)
        return out

    def _draft_sync(self, depths):
        """Replay each lane's backlog of committed-but-unwritten rows
        through the draft (lockstep across lanes, positions are
        contiguous per lane) so the next rollout conditions on the real
        stream. Proposals from replay steps are discarded — the tokens
        are already committed."""
        backlogs = {s: list(self._draft_backlog[s]) for s in depths
                    if self._draft_backlog[s]}
        if not backlogs:
            return
        for s, bl in backlogs.items():
            self.draft.seek_slot(s, bl[0][0])
        for i in range(max(len(bl) for bl in backlogs.values())):
            fed = {s: bl[i][1] for s, bl in backlogs.items()
                   if i < len(bl)}
            if fed:
                self.draft.decode(fed)
        for s in backlogs:
            self._draft_backlog[s].clear()

    def _note_round(self, out, offered, accepted, verify_round):
        with self._spec_lock:
            if verify_round:
                self._emit_verify += sum(len(v) for v in out.values())
                self._lane_rounds += len(out)
                self._drafts_offered += offered
                self._drafts_accepted += accepted
            self._win.append((len(out),
                              sum(len(v) for v in out.values()),
                              offered, accepted))
            lanes = sum(w[0] for w in self._win)
            toks = sum(w[1] for w in self._win)
            off = sum(w[2] for w in self._win)
            acc = sum(w[3] for w in self._win)
            aps = toks / lanes if lanes else 0.0
            rate = acc / off if off else 0.0
            decide = sum(1 for w in self._win if w[2] > 0)
            if offered and rate < self.disable_below and \
                    decide >= _MIN_DECIDE_ROUNDS:
                # divergence storm: speculation off for probe_steps
                # rounds, window cleared so the probe gets a fresh vote
                self._plain_until = self._spec_rounds + self.probe_steps
                self._degrade_events += 1
                self._win.clear()
        self._aps_g.set(aps)
        self._rate_g.set(rate)

    # -- measured-gate surfaces ----------------------------------------------
    def spec_bytes_per_accepted_token(self):
        """Counted bytes per committed token on the speculative path:
        (verify launches x the verify program's ``program_cost`` bytes +
        ALL draft decode launches x the draft step's, replays included) /
        tokens committed by verify rounds; ``None`` before any verify
        round. A count from shapes, as ``program_cost`` is."""
        vb = float(self.program_cost(
            "verify", self.spec_k + 1).get("bytes accessed", 0.0))
        db = float(self.draft.program_cost("decode").get(
            "bytes accessed", 0.0))
        with self._spec_lock:
            emitted = self._emit_verify
        if not vb or not db or not emitted:
            return None
        with self._lock:
            vsteps = self._verify_steps
        with self.draft._lock:
            dsteps = self.draft._decode_steps
        return (vsteps * vb + dsteps * db) / emitted

    # -- observability --------------------------------------------------------
    @property
    def degraded(self):
        """True while a divergence storm has speculation switched off
        (plain-decode rounds until the probe)."""
        with self._spec_lock:
            return self._spec_rounds < self._plain_until

    def report(self, reset=False):
        out = super().report(reset=reset)
        with self._spec_lock:
            lanes = sum(w[0] for w in self._win)
            off = sum(w[2] for w in self._win)
            out["spec"] = {
                "k": self.spec_k,
                "draft_id": self.draft.telemetry_id,
                "rounds": self._spec_rounds,
                "accepted_per_step":
                    (self._emit_verify / self._lane_rounds)
                    if self._lane_rounds else None,
                "acceptance_rate":
                    (self._drafts_accepted / self._drafts_offered)
                    if self._drafts_offered else None,
                "windowed_accepted_per_step":
                    (sum(w[1] for w in self._win) / lanes)
                    if lanes else None,
                "windowed_acceptance_rate":
                    (sum(w[3] for w in self._win) / off)
                    if off else None,
                "degraded": self._spec_rounds < self._plain_until,
                "degrade_events": self._degrade_events,
                "bytes_per_accepted_token": None,
            }
            if reset:
                self._emit_verify = 0
                self._lane_rounds = 0
                self._drafts_offered = 0
                self._drafts_accepted = 0
                self._win.clear()
        out["spec"]["bytes_per_accepted_token"] = \
            self.spec_bytes_per_accepted_token() if not reset else None
        return out
