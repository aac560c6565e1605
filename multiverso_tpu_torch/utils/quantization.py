"""Wire compression filters for host<->device / cross-process transfer.

Port of ``multiverso_tpu/utils/quantization.py`` (numpy only, bitwise the
JAX module).

Parity with ``include/multiverso/util/quantization_util.h:10-164``:

* ``SparseFilter``: sparsify a buffer to (index, value) pairs when more than
  half the entries are within a clip threshold of zero; a side-channel marks
  whether the payload is compressed (-1 = raw there; a bool here).
* ``OneBitsFilter``: 1-bit quantization with per-buffer scale + error
  feedback — an empty stub in the reference (``:160-161``), implemented here.
* ``f32_to_bf16_bits``/``bf16_bits_to_f32``: a middle ground the
  reference predates — bfloat16 wire truncation (round-to-nearest-even)
  halves wire bytes at ~3 decimal digits of delta precision, no sender
  state needed.

Used where bytes actually cross a slow link (host staging drains, cross-process
transfers, checkpoint streams); traffic on the card needs no filtering.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SparseFilter:
    """(index, value) compaction for mostly-small buffers
    (ref quantization_util.h FilterIn/FilterOut)."""

    def __init__(self, clip: float = 0.0):
        self.clip = clip

    def filter_in(self, values: np.ndarray
                  ) -> Tuple[bool, np.ndarray, Optional[np.ndarray]]:
        """Returns (compressed, payload, indices). Compresses only when >50%
        of entries are within the clip threshold (the reference's rule).
        A zero-length buffer is raw by definition (nothing to sparsify):
        the >50% rule degenerates to a 0 <= 0 tie there, and relying on
        the tie-break direction made empty SERVE_REPLY / empty-shard
        payloads one refactor away from a shape error."""
        flat = np.asarray(values).ravel()
        if flat.size == 0:
            return False, flat, None
        small = np.abs(flat) <= self.clip
        if small.sum() * 2 <= len(flat):
            return False, flat, None
        idx = np.flatnonzero(~small).astype(np.int32)
        return True, flat[idx], idx

    def filter_out(self, compressed: bool, payload: np.ndarray,
                   indices: Optional[np.ndarray], size: int,
                   dtype=np.float32) -> np.ndarray:
        if not compressed:
            return payload.astype(dtype, copy=False).reshape(size)
        out = np.zeros(size, dtype=dtype)
        if indices is None or len(indices) == 0:
            # All entries were clipped (or the buffer was empty): the
            # decoded result is exactly zeros. Skipping the fancy-index
            # assignment matters: ``out[None] = payload`` would broadcast
            # the payload over the WHOLE buffer instead of writing no rows.
            return out
        out[indices] = payload
        return out


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern as uint16, round-to-nearest-even
    (the 16-bit format; numpy has no bf16 dtype, so the wire
    carries the raw upper halves). NaNs map to quiet NaN — the rounding
    bias would otherwise turn them into inf (low payload) or wrap to 0
    (negative NaN), silently masking a diverged gradient."""
    b = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = ((b & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) \
        & ((b & np.uint32(0x007FFFFF)) != 0)
    if nan.any():
        sign = (b[nan] >> np.uint32(16)).astype(np.uint16) \
            & np.uint16(0x8000)
        out[nan] = sign | np.uint16(0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit pattern -> float32 (exact)."""
    return (np.ascontiguousarray(bits, dtype=np.uint16)
            .astype(np.uint32) << np.uint32(16)).view(np.float32)


class OneBitsFilter:
    """1-bit SGD quantization with error feedback (stateful per link)."""

    def __init__(self, size: int):
        self._residual = np.zeros(size, dtype=np.float32)

    def encode(self, values: np.ndarray
               ) -> Tuple[np.ndarray, float, float]:
        """Returns (bits packed as uint8, pos_scale, neg_scale); adds the
        carried quantization error before encoding."""
        v = np.asarray(values, dtype=np.float32).ravel() + self._residual
        pos = v > 0
        pos_scale = float(v[pos].mean()) if pos.any() else 0.0
        neg_scale = float(v[~pos].mean()) if (~pos).any() else 0.0
        decoded = np.where(pos, pos_scale, neg_scale).astype(np.float32)
        self._residual = v - decoded
        return np.packbits(pos), pos_scale, neg_scale

    @staticmethod
    def decode(bits: np.ndarray, pos_scale: float, neg_scale: float,
               size: int) -> np.ndarray:
        pos = np.unpackbits(bits, count=size).astype(bool)
        return np.where(pos, np.float32(pos_scale),
                        np.float32(neg_scale))
