"""2-bit gradient compression with error feedback (counterpart of
``mxnet_tpu/gradient_compression.py``; reference:
src/kvstore/gradient_compression.h:37-134).

Per element, with ``v = grad + residual``:

- v >= threshold   -> code ``11``, sends +threshold, residual v - threshold
- v <= -threshold  -> code ``10``, sends -threshold, residual v + threshold
- otherwise        -> code ``00``, sends 0, residual v

Wire format: 16 two-bit codes packed per 32-bit word, string position p
of the reference's MSB-first bit string at bit ``8*(p//8) + 7 - p%8`` of
the word, so a packed buffer is bit for bit the JAX package's (and the
reference's). Plain PyTorch in float32; the codes of an element never
share a bit with another's, so a word is the sum of its elements' bits.
"""
from __future__ import annotations

import torch

__all__ = ["GradientCompression", "quantize_2bit", "dequantize_2bit"]


def _bit_index(p):
    """String position -> bit index in the packed 32-bit word."""
    return 8 * (p // 8) + 7 - (p % 8)


def _words_as_float(words):
    """int64 values in [0, 2**32) as the float32 bit patterns of the
    uint32 words."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.int32).view(torch.float32)


def quantize_2bit(grad, residual, threshold):
    """(packed float32 buffer, new residual, dequantized values) of
    ``grad`` with error feedback ``residual``."""
    grad = torch.as_tensor(grad, dtype=torch.float32)
    residual = torch.as_tensor(residual, dtype=torch.float32,
                               device=grad.device)
    threshold = float(threshold)
    flat = grad.reshape(-1) + residual.reshape(-1)
    n = flat.shape[0]
    pos = flat >= threshold
    neg = flat <= -threshold
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    dequant = torch.where(pos, zero + threshold,
                          torch.where(neg, zero - threshold, zero))
    new_residual = (flat - dequant).reshape(grad.shape)
    idx = torch.arange(n, device=flat.device)
    one = torch.ones((), dtype=torch.int64, device=flat.device)
    hi = one << _bit_index(2 * (idx % 16))        # marker: + and -
    lo = one << _bit_index(2 * (idx % 16) + 1)    # sign: + only
    contrib = torch.where(pos | neg, hi, 0) + torch.where(pos, lo, 0)
    words = torch.zeros((n + 15) // 16, dtype=torch.int64,
                        device=flat.device)
    words.index_add_(0, idx // 16, contrib)
    return _words_as_float(words), new_residual, dequant.reshape(grad.shape)


def dequantize_2bit(packed, n, threshold, shape=None):
    """Decode a packed buffer of ``n`` elements back to {-t, 0, +t}."""
    packed = torch.as_tensor(packed, dtype=torch.float32)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(int(n), device=packed.device)
    w = words[idx // 16]
    hi = (w >> _bit_index(2 * (idx % 16))) & 1
    lo = (w >> _bit_index(2 * (idx % 16) + 1)) & 1
    t = float(threshold)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    out = torch.where(hi == 1, torch.where(lo == 1, zero + t, zero - t),
                      zero)
    return out.reshape(shape) if shape is not None else out


class GradientCompression:
    """Per-key compression state (reference: gradient_compression.h:52,
    kTwoBit)."""

    def __init__(self, type="2bit", threshold=0.5):
        if str(type) not in ("2bit", "none"):
            raise ValueError(f"unsupported compression type {type!r}")
        self.type = str(type)
        self.threshold = float(threshold)
        self._residuals = {}

    @property
    def active(self):
        return self.type == "2bit"

    def compress(self, key, grad):
        """Quantize ``grad`` (a tensor) with the key's error feedback;
        the dequantized gradient (what the receiving end rebuilds)."""
        if not self.active:
            return grad
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        _, new_res, dequant = quantize_2bit(grad, res, self.threshold)
        self._residuals[key] = new_res
        return dequant.to(grad.dtype)

    def get_compressed_size(self, original_size):
        """Bytes on the wire (reference: GetCompressedSize)."""
        return ((original_size + 15) // 16) * 4 if self.active \
            else original_size * 4

    def encode_params(self):
        return {"type": self.type, "threshold": self.threshold}
