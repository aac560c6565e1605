"""Storage codecs for the decode-side memory hierarchy.

Port of ``multiverso_tpu/serving/quant.py`` for the codecs the paged
decode read (B7, ``ops/attention.py::paged_decode_attn``) takes:

* ``f32`` (default) is the IDENTITY codec: :func:`encode_rows` and
  :func:`decode_rows` return their input tensor object untouched, so an
  f32 path is the unquantized path. The scale plane is a ones plane of
  the row shape, as in the JAX package.
* ``bf16`` stores ``bfloat16`` payloads (relative error <= 2^-8 per
  element after the round-trip) and no real scale.
* ``int8`` stores symmetric per-ROW absmax-scaled int8: one float32
  scale per row (the last axis is the row), ``absmax / 127`` or 1 where
  the row is all zeros, and ``clip(round(x / scale), -127, 127)``
  (``torch.round`` rounds half to even, as ``jnp.round`` does, so payload
  and scale are the JAX package's bit for bit); ``|x -
  decode(encode(x))| <= absmax(row) / 254``.

:func:`encode_table` converts one checkpointed replica table into its
storage form on the device (``serving/replica.py``); the int8 payload and
scale are computed in numpy exactly as the JAX package computes them, so
they are its bytes bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.utils.log import check

#: Storage dtypes the serving plane names (flags validate against this).
STORAGE_DTYPES = ("f32", "bf16", "int8")

_INT8_MAX = 127.0


def storage_dtype(name: str) -> str:
    """Validate + canonicalize a ``-serve_kv_dtype``/``-serve_table_dtype``
    value."""
    name = str(name).strip().lower() or "f32"
    check(name in STORAGE_DTYPES,
          f"unknown storage dtype '{name}' (want one of {STORAGE_DTYPES})")
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype payloads are stored as."""
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[storage_dtype(name)]


def has_scale(name: str) -> bool:
    """Whether the codec carries a per-row scale plane (int8 only)."""
    return storage_dtype(name) == "int8"


def bytes_per_element(name: str) -> float:
    """Storage bytes per payload element."""
    return {"f32": 4.0, "bf16": 2.0, "int8": 1.0}[storage_dtype(name)]


def encode_rows(x: torch.Tensor, dtype: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``x`` (float32, row = last axis) into storage form:
    ``(payload, scale)`` with ``scale`` of ``x``'s shape, last axis 1
    (float32; a ones plane for f32 and bf16, which carry no real
    scale)."""
    dtype = storage_dtype(dtype)
    if dtype != "int8":
        ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                          device=x.device)
        return (x if dtype == "f32" else x.to(torch.bfloat16)), ones
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / _INT8_MAX,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.round(x / scale).clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, scale


def decode_rows(payload: torch.Tensor, scale: torch.Tensor,
                dtype: str) -> torch.Tensor:
    """Inverse of :func:`encode_rows`: the read-side dequant. f32 returns
    the payload OBJECT untouched; int8 is ``payload.float() * scale``."""
    dtype = storage_dtype(dtype)
    if dtype == "f32":
        return payload
    if dtype == "bf16":
        return payload.to(torch.float32)
    return payload.to(torch.float32) * scale


def roundtrip_bound(x: np.ndarray, dtype: str) -> float:
    """The worst-case absolute error ``decode(encode(x))`` may show: what
    the bounded-error tests assert against. 0 for f32."""
    dtype = storage_dtype(dtype)
    x = np.asarray(x, np.float32)
    if dtype == "f32" or not x.size:
        return 0.0
    if dtype == "bf16":
        # bf16 keeps 8 mantissa bits: rel err <= 2^-9 + one ulp slack.
        return float(np.max(np.abs(x)) * 2.0 ** -8)
    absmax = np.max(np.abs(x), axis=-1, keepdims=True)
    # round() is within half a quantization step; scale = absmax/127.
    return float(np.max(absmax) / (2.0 * _INT8_MAX))


def encode_table(data: np.ndarray, dtype: str,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Host->device conversion of one 2-D replica table into storage
    form (the once-per-checkpoint-swap amortization point). Returns
    ``(device payload, device scale-or-None)``: f32 as is (the table's
    own dtype), bf16 by a cast
    (round to nearest even, as ``jnp.asarray(data, bfloat16)``), int8
    with a float32 per-row absmax scale ``[rows, 1]`` (``np.round``,
    clipped to +-127), both computed in numpy as the JAX package does."""
    dtype = storage_dtype(dtype)
    if dtype == "f32":
        return torch.as_tensor(np.array(data), device=device), None
    arr = np.asarray(data, np.float32)
    if dtype == "bf16":
        return torch.as_tensor(np.array(arr), device=device).to(
            torch.bfloat16), None
    absmax = np.max(np.abs(arr), axis=-1, keepdims=True)
    scale = np.where(absmax > 0, absmax / _INT8_MAX, 1.0) \
        .astype(np.float32)
    q = np.clip(np.round(arr / scale), -_INT8_MAX, _INT8_MAX) \
        .astype(np.int8)
    return (torch.as_tensor(q, device=device),
            torch.as_tensor(scale, device=device))
