"""Transformer LM for decode serving: the spec, its parameters and the
serving programs as functions on tensors (counterpart of
``mxnet_tpu/serving/decode/model.py``).

The same named parameters drive four programs: ``prefill_step`` (a
whole padded prompt fills one lane of the KV-cache and emits token #1),
``decode_step`` (one token for every lane against the cache),
``verify_step`` (up to K tokens a lane in one program, for speculative
decoding) and ``reprefill_step`` (the cacheless baseline). The engine
(engine.py) captures them as CUDA graphs on the card.

KV-cache layout (the JAX package's): per layer one K and one V buffer of
shape ``(slots, max_seq, num_heads, head_dim)`` float32 or, with
``kv_dtype="int8"``, an int8 value buffer plus a float32 scale buffer
``(slots, max_seq, num_heads)`` each: one symmetric absmax scale per
cache row, so a row costs ``head_dim + 4`` bytes instead of
``4 * head_dim``. Rows quantize on write; the decode-attention kernel
(``ops/decode_attention.py``) dequantizes on load.

What differs from the JAX package:

- The cache is updated in place (the counterpart of XLA's donation):
  each function writes its rows into the given buffers and returns them.
- Writes the JAX package drops with ``mode="drop"`` at the sentinel
  ``max_seq`` (inactive lanes, padded verify tokens): PyTorch has no
  drop mode, negative indices wrap and duplicate indices write in an
  undefined order. Here each lane writes exactly W distinct rows a step
  (``_row_index``): the row a token feeds, or its old contents back
  where the JAX package drops the write.
- Decode and verify attention go through D1's wrapper; its plain
  version is the JAX package's einsum math.
- Token and position ids are clamped into range before the embedding
  gathers, as XLA clamps an out-of-range gather (PyTorch would fault).
  The training symbol's ``Embedding`` op keeps ``jnp.take``'s own
  semantics instead (wrap, then NaN rows), as the JAX package's does.

``build_symbol`` gives the training symbol of the same parameters
(Embedding, learned positions, pre-LN ``CausalSelfAttention`` blocks,
the head and ``SoftmaxOutput``), which ``Module.fit`` trains and
``DecodePredictor.from_module`` serves.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
from ...ops import decode_attention as _da

__all__ = ["TransformerLMSpec", "build_symbol", "init_params", "init_caches",
           "check_kv_dtype", "KV_DTYPES", "prefill_step", "decode_step",
           "verify_step", "reprefill_step"]

_NEG = -1e30
_LN_EPS = 1e-5
_KV_SCALE_FLOOR = 1e-12
KV_DTYPES = ("float32", "int8")


def check_kv_dtype(kv_dtype):
    kd = str(kv_dtype).strip().lower()
    if kd not in KV_DTYPES:
        raise MXNetError(
            f"kv_dtype={kv_dtype!r} not supported (one of {KV_DTYPES}; "
            "set via MXTPU_DECODE_KV_DTYPE)")
    return kd


class TransformerLMSpec:
    """Static architecture of the decode-servable transformer LM (pre-LN
    blocks without biases, a ReLU FFN, learned positions and an untied
    head). Everything here is compile-key material."""

    def __init__(self, vocab_size, num_embed=64, num_heads=4,
                 num_layers=2, max_seq=64, ffn_hidden=None, name="lm"):
        if num_embed % num_heads:
            raise MXNetError(
                f"num_embed={num_embed} not divisible by "
                f"num_heads={num_heads}")
        self.vocab_size = int(vocab_size)
        self.num_embed = int(num_embed)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.max_seq = int(max_seq)
        self.ffn_hidden = int(ffn_hidden or 4 * num_embed)
        self.head_dim = self.num_embed // self.num_heads
        self.name = name

    def param_shapes(self):
        """Ordered ``{name: shape}``: the naming contract shared with the
        JAX package's training symbol and serving programs."""
        d, f, v = self.num_embed, self.ffn_hidden, self.vocab_size
        out = {
            "tok_emb_weight": (v, d),
            "pos_emb_weight": (self.max_seq, d),
        }
        for i in range(self.num_layers):
            out[f"l{i}_ln1_gamma"] = (d,)
            out[f"l{i}_ln1_beta"] = (d,)
            out[f"l{i}_qkv_weight"] = (3 * d, d)
            out[f"l{i}_proj_weight"] = (d, d)
            out[f"l{i}_ln2_gamma"] = (d,)
            out[f"l{i}_ln2_beta"] = (d,)
            out[f"l{i}_ffn1_weight"] = (f, d)
            out[f"l{i}_ffn2_weight"] = (d, f)
        out["lnf_gamma"] = (d,)
        out["lnf_beta"] = (d,)
        out["head_weight"] = (v, d)
        return out

    def param_names(self):
        return list(self.param_shapes())

    def key_material(self):
        """Spec fingerprint for ``compile.program_key`` extras."""
        return {
            "vocab": self.vocab_size, "embed": self.num_embed,
            "heads": self.num_heads, "layers": self.num_layers,
            "max_seq": self.max_seq, "ffn": self.ffn_hidden,
        }

    def kv_cache_bytes(self, slots, kv_dtype="float32"):
        """KV-cache footprint for ``slots`` lanes. f32: layers x {K,V} x
        slots x max_seq x heads x head_dim x 4; int8: ``head_dim + 4``
        bytes per row (the int8 values and one f32 scale)."""
        rows = (self.num_layers * 2 * int(slots) * self.max_seq
                * self.num_heads)
        if check_kv_dtype(kv_dtype) == "int8":
            return rows * (self.head_dim + 4)
        return rows * self.head_dim * 4


def build_symbol(spec, seq_len, name="softmax"):
    """Training / scoring symbol at a fixed ``seq_len``, node for node the
    JAX package's: ``data`` is a ``(batch, seq_len)`` token matrix, the
    output the per-position next-token distribution; ``softmax_label``
    binds as ``(batch, seq_len)`` shifted targets. Its parameters are
    ``spec.param_shapes()``."""
    from ... import symbol as sym

    if seq_len > spec.max_seq:
        raise MXNetError(
            f"seq_len={seq_len} exceeds spec.max_seq={spec.max_seq}")
    data = sym.Variable("data")
    x = sym.Embedding(data=data, weight=sym.Variable("tok_emb_weight"),
                      input_dim=spec.vocab_size,
                      output_dim=spec.num_embed, name="tok_emb")
    pos = sym.Variable("pos_emb_weight",
                       shape=(spec.max_seq, spec.num_embed))
    x = sym.broadcast_add(x, pos.slice_axis(0, 0, seq_len),
                          name="pos_add")

    def ln(h, prefix):
        return sym.LayerNorm(h, gamma=sym.Variable(f"{prefix}_gamma"),
                             beta=sym.Variable(f"{prefix}_beta"),
                             axis=-1, eps=_LN_EPS, name=prefix)

    def fc(h, wname, hidden):
        return sym.FullyConnected(
            h, weight=sym.Variable(f"{wname}_weight"), num_hidden=hidden,
            no_bias=True, flatten=False, name=wname)

    for i in range(spec.num_layers):
        qkv = fc(ln(x, f"l{i}_ln1"), f"l{i}_qkv", 3 * spec.num_embed)
        attn = sym.CausalSelfAttention(qkv, num_heads=spec.num_heads,
                                       name=f"l{i}_attn")
        x = sym.elemwise_add(x, fc(attn, f"l{i}_proj", spec.num_embed),
                             name=f"l{i}_res1")
        f1 = sym.Activation(fc(ln(x, f"l{i}_ln2"), f"l{i}_ffn1",
                               spec.ffn_hidden),
                            act_type="relu", name=f"l{i}_relu")
        x = sym.elemwise_add(x, fc(f1, f"l{i}_ffn2", spec.num_embed),
                             name=f"l{i}_res2")
    logits = fc(ln(x, "lnf"), "head", spec.vocab_size)
    return sym.SoftmaxOutput(logits, name=name)


def init_params(spec, seed=0, scale=0.02):
    """Deterministic random parameters (numpy, float32), the JAX
    package's draws in its order: LN affines at identity, every other
    tensor N(0, scale) from one ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    out = {}
    for n, s in spec.param_shapes().items():
        if n.endswith("_gamma"):
            out[n] = np.ones(s, np.float32)
        elif n.endswith("_beta"):
            out[n] = np.zeros(s, np.float32)
        else:
            out[n] = rs.normal(0.0, scale, s).astype(np.float32)
    return out


def init_caches(spec, slots, kv_dtype="float32", device="cpu"):
    """Zeroed cache buffers for ``slots`` lanes on ``device``: per layer
    ``[K, V]`` (f32) or ``[Kq, Kscale, Vq, Vscale]`` (int8), as one
    flat list (the persistent device state of the programs)."""
    kd = check_kv_dtype(kv_dtype)
    vshape = (int(slots), spec.max_seq, spec.num_heads, spec.head_dim)
    out = []
    for _ in range(spec.num_layers):
        for _kv in range(2):
            if kd == "int8":
                out.append(torch.zeros(vshape, dtype=torch.int8,
                                       device=device))
                out.append(torch.zeros(vshape[:3], dtype=torch.float32,
                                       device=device))
            else:
                out.append(torch.zeros(vshape, dtype=torch.float32,
                                       device=device))
    return out


# ---------------------------------------------------------------------------
# the serving math (captured by engine.py)
# ---------------------------------------------------------------------------

def _kv_quant_rows(rows):
    """Quantize fresh K/V rows ``(..., H, D)`` to (int8 rows, f32 per-row
    scales ``(..., H)``): symmetric absmax over head_dim, the floor keeps
    an all-zero row's scale finite. ``rows / scale`` stays a division, as
    in the JAX package, so the roundings agree."""
    amax = torch.amax(torch.abs(rows), dim=-1)
    scale = torch.clamp_min(amax * (1.0 / 127.0), _KV_SCALE_FLOOR)
    q = torch.clamp(torch.round(rows / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


# f32 values of a quantized cache buffer: the plain attention's
# dequantization (D1 does it on load)
_kv_dequant = _da.kv_dequant


def _ln(x, gamma, beta):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * gamma + beta


def _split_qkv(qkv, heads, head_dim):
    """(..., 3*H*D) -> three contiguous (..., H, D)."""
    q = qkv.reshape(qkv.shape[:-1] + (3, heads, head_dim))
    return (q[..., 0, :, :].contiguous(), q[..., 1, :, :].contiguous(),
            q[..., 2, :, :].contiguous())


def _block_tail(spec, p, i, x, attn_out):
    """proj + residual + FFN shared by every program."""
    x = x + attn_out @ p[f"l{i}_proj_weight"].T
    h2 = _ln(x, p[f"l{i}_ln2_gamma"], p[f"l{i}_ln2_beta"])
    f = torch.clamp_min(h2 @ p[f"l{i}_ffn1_weight"].T, 0.0)
    return x + f @ p[f"l{i}_ffn2_weight"].T


def _head(spec, p, x_last):
    """Final LN and head on the last position only: (tokens int32,
    logits). Ties go to the first index, as ``jnp.argmax``."""
    xl = _ln(x_last, p["lnf_gamma"], p["lnf_beta"])
    logits = xl @ p["head_weight"].T
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def _ids(x, n, device):
    """Int ids (Python int, numpy or tensor) as a long tensor on
    ``device``, clamped into [0, n) as XLA clamps a gather."""
    t = torch.as_tensor(x, device=device)
    return torch.clamp(t.long(), 0, n - 1)


def _embed(spec, p, tokens, positions):
    return (p["tok_emb_weight"][_ids(tokens, spec.vocab_size,
                                     p["tok_emb_weight"].device)]
            + p["pos_emb_weight"][_ids(positions, spec.max_seq,
                                       p["pos_emb_weight"].device)])


def _flat(c):
    """A cache buffer viewed as one row per (slot, position)."""
    return c.view((c.shape[0] * c.shape[1],) + tuple(c.shape[2:]))


def _row_index(max_seq, positions, fed):
    """Rows written by one decode or verify step: lane ``n``'s token
    ``j`` feeds position ``t = positions[n] + j``. Returns (flat row
    index ``n * max_seq + r``, take-new mask), both (N, W). A fed token
    inside the cache writes its row (``r = t``); a token the JAX package
    drops (not fed, or ``t >= max_seq``) writes the row's old contents
    back, at ``r = t`` or, past the end, at ``r = min(positions[n],
    max_seq) + j - W``, below every row inside. The W rows of one lane
    are therefore distinct, so no two writes of a step share a row:
    ``index_copy_`` has no order to get wrong (``max_seq >= W``)."""
    n, w = fed.shape
    j = torch.arange(w, device=fed.device)
    base = positions.long()[:, None]
    t = base + j
    inside = t < max_seq
    r = torch.where(inside, t, torch.clamp_max(base, max_seq) + j - w)
    lanes = torch.arange(n, device=fed.device)[:, None]
    return lanes * max_seq + r, fed & inside


def _write_rows(caches, i, int8_kv, flat_idx, take, k, v):
    """Write layer ``i``'s new K/V rows ``(..., H, D)`` at ``flat_idx``
    in place: where ``take``, the old rows elsewhere (``take=None``:
    every row new)."""
    idx = flat_idx.reshape(-1)
    if int8_kv:
        kqi, ksc = _kv_quant_rows(k)
        vqi, vsc = _kv_quant_rows(v)
        news = (kqi, ksc, vqi, vsc)
        bufs = caches[4 * i: 4 * i + 4]
    else:
        news = (k, v)
        bufs = caches[2 * i: 2 * i + 2]
    for buf, new in zip(bufs, news):
        fb = _flat(buf)
        new = new.reshape((-1,) + tuple(fb.shape[1:])).to(buf.dtype)
        if take is not None:
            sel = take.reshape((-1,) + (1,) * (new.dim() - 1))
            # an indexing gather, not index_select: the latter's
            # small-index kernel was among the decode step's largest
            new = torch.where(sel, new, fb[idx])
        fb.index_copy_(0, idx, new)


def _layer_cache(caches, i, int8_kv):
    """(k, v, k_scale, v_scale) of layer ``i`` for the attention."""
    if int8_kv:
        kq, ks, vq, vs = caches[4 * i: 4 * i + 4]
        return kq, vq, ks, vs
    return caches[2 * i], caches[2 * i + 1], None, None


def _prompt_attention(spec, q, k, v):
    """Causal self-attention of one prompt ``(S, H, D)`` on its own exact
    k/v: plain matmul and softmax, as the JAX package's einsum."""
    sb = q.shape[0]
    scale = 1.0 / (spec.head_dim ** 0.5)
    ar = torch.arange(sb, device=q.device)
    causal = ar[:, None] >= ar[None, :]
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    s = torch.where(causal[None], s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    w = torch.exp(s - m)
    o = torch.einsum("hqk,khd->qhd", w, v)
    return o / torch.sum(w, dim=-1, keepdim=True).transpose(0, 1)


def _last_row(x, length):
    """``x[length - 1]`` with ``length`` an int or a device scalar."""
    idx = torch.as_tensor(length, device=x.device).long().reshape(1) - 1
    return x.index_select(0, idx)[0]


def _prefill(spec, p, caches, tokens, length, slot, kv_dtype):
    """prefill_step's body: returns (next token, logits)."""
    int8_kv = check_kv_dtype(kv_dtype) == "int8"
    sb = tokens.shape[1]
    dev = p["tok_emb_weight"].device
    x = _embed(spec, p, tokens[0], torch.arange(sb, device=dev))
    rows = (torch.as_tensor(slot, device=dev).long().reshape(1)
            * spec.max_seq + torch.arange(sb, device=dev))
    for i in range(spec.num_layers):
        h = _ln(x, p[f"l{i}_ln1_gamma"], p[f"l{i}_ln1_beta"])
        q, k, v = _split_qkv(h @ p[f"l{i}_qkv_weight"].T,
                             spec.num_heads, spec.head_dim)
        _write_rows(caches, i, int8_kv, rows, None, k, v)
        o = _prompt_attention(spec, q, k, v)
        x = _block_tail(spec, p, i, x, o.reshape(sb, -1))
    return _head(spec, p, _last_row(x, length))


def prefill_step(spec, p, caches, tokens, length, slot,
                 kv_dtype="float32"):
    """Fill one slot's KV rows from a padded prompt; emit token #1.

    tokens: (1, Sb) int32 padded prompt (Sb = static seq bucket);
    length: the true prompt length; slot: the lane (ints or device
    scalars). Rows [length, Sb) hold pad K/V that decode overwrites or
    masks. Attention runs on the prompt's exact f32 k/v; only the rows
    written are quantized under int8. Returns ``(caches, next_token)``,
    the caches written in place."""
    return caches, _prefill(spec, p, caches, tokens, length, slot,
                            kv_dtype)[0]


def _multi(spec, p, caches, tokens, positions, fed, kv_dtype):
    """decode / verify body on (N, W) tokens: (next tokens (N, W),
    logits (N, W, V))."""
    int8_kv = check_kv_dtype(kv_dtype) == "int8"
    n, w = tokens.shape
    dev = p["tok_emb_weight"].device
    positions = torch.as_tensor(positions, device=dev)
    pos = positions.long()[:, None] + torch.arange(w, device=dev)
    x = _embed(spec, p, tokens, torch.where(fed, pos, 0))
    flat_idx, take = _row_index(spec.max_seq, positions, fed)
    pos32 = positions.to(torch.int32).contiguous()
    for i in range(spec.num_layers):
        h = _ln(x, p[f"l{i}_ln1_gamma"], p[f"l{i}_ln1_beta"])
        q, k, v = _split_qkv(h @ p[f"l{i}_qkv_weight"].T,
                             spec.num_heads, spec.head_dim)
        _write_rows(caches, i, int8_kv, flat_idx, take, k, v)
        kc, vc, ks, vs = _layer_cache(caches, i, int8_kv)
        o = _da.decode_attention(q, kc, vc, pos32, ks, vs)
        x = _block_tail(spec, p, i, x, o.reshape(n, w, -1))
    return _head(spec, p, x)


def _decode(spec, p, caches, tokens, positions, active, kv_dtype):
    """decode_step's body: (next tokens (N,), logits (N, V))."""
    dev = p["tok_emb_weight"].device
    active = torch.as_tensor(active, device=dev).bool()
    nxt, logits = _multi(spec, p, caches,
                         torch.as_tensor(tokens, device=dev)[:, None],
                         positions, active[:, None], kv_dtype)
    return nxt[:, 0], logits[:, 0]


def decode_step(spec, p, caches, tokens, positions, active,
                kv_dtype="float32"):
    """Advance every active slot by ONE token against the cache.

    tokens: (slots,) int32 each lane's previous token; positions:
    (slots,) int32 the position it occupies; active: (slots,) bool.
    Inactive lanes write nothing (their old rows back) and emit garbage
    the caller discards. Lanes are independent: batched rows equal solo
    rows bit for bit. Returns ``(caches, next_tokens (slots,) int32)``."""
    return caches, _decode(spec, p, caches, tokens, positions, active,
                           kv_dtype)[0]


def _verify(spec, p, caches, tokens, positions, n_tokens, active,
            kv_dtype):
    """verify_step's body: (out (N, K) int32, logits (N, K, V))."""
    dev = p["tok_emb_weight"].device
    tokens = torch.as_tensor(tokens, device=dev)
    n_tokens = torch.as_tensor(n_tokens, device=dev)
    active = torch.as_tensor(active, device=dev).bool()
    j = torch.arange(tokens.shape[1], device=dev)
    fed = active[:, None] & (j[None, :] < n_tokens.long()[:, None])
    return _multi(spec, p, caches, tokens, positions, fed, kv_dtype)


def verify_step(spec, p, caches, tokens, positions, n_tokens, active,
                kv_dtype="float32"):
    """Advance every active slot by UP TO K tokens in one program (the
    speculative verify step).

    tokens: (slots, K) int32, token j of a lane fed at ``positions + j``
    (token 0 the last committed token, the rest draft proposals);
    positions: (slots,) int32 base positions; n_tokens: (slots,) int32 in
    [1, K], the tokens a lane feeds (the tail is padding that writes
    nothing); active: (slots,) bool. Token j sees cache rows ``<=
    positions + j``. Returns ``(caches, out (slots, K) int32)`` with
    ``out[s, j]`` the greedy token after fed token j: ``out[s, 0]`` is
    what ``decode_step`` would emit."""
    return caches, _verify(spec, p, caches, tokens, positions, n_tokens,
                           active, kv_dtype)[0]


def reprefill_step(spec, p, tokens, length):
    """The cacheless baseline: the whole prompt's forward and the next
    token, touching no KV state (what a server without a cache runs per
    generated token)."""
    sb = tokens.shape[1]
    dev = p["tok_emb_weight"].device
    x = _embed(spec, p, tokens[0], torch.arange(sb, device=dev))
    for i in range(spec.num_layers):
        h = _ln(x, p[f"l{i}_ln1_gamma"], p[f"l{i}_ln1_beta"])
        q, k, v = _split_qkv(h @ p[f"l{i}_qkv_weight"].T,
                             spec.num_heads, spec.head_dim)
        o = _prompt_attention(spec, q, k, v)
        x = _block_tail(spec, p, i, x, o.reshape(sb, -1))
    return _head(spec, p, _last_row(x, length))[0]
