"""Storage codecs for the decode-side memory hierarchy.

Port of ``multiverso_tpu/serving/quant.py`` for the codecs the paged
decode read (B7, ``ops/attention.py::paged_decode_attn``) takes:

* ``f32`` (default) is the IDENTITY codec: :func:`encode_rows` and
  :func:`decode_rows` return their input tensor object untouched, so an
  f32 path is the unquantized path. The scale plane is a ones plane of
  the row shape, as in the JAX package.
* ``bf16`` stores ``bfloat16`` payloads (relative error <= 2^-8 per
  element after the round-trip) and no real scale.

``int8`` (symmetric per-row absmax scales) is validated as a name but
raises ``NotImplementedError``: B7 reads no scale planes yet (ROADMAP B7,
"B7 with int8 scale planes"). ``encode_table`` belongs to the replica
tables and waits with them (ROADMAP A9).
"""

from __future__ import annotations

from typing import Tuple

import torch

from multiverso_tpu_torch.utils.log import check

#: Storage dtypes the serving plane names (flags validate against this).
STORAGE_DTYPES = ("f32", "bf16", "int8")

INT8_KV = ("int8 KV storage (-serve_kv_dtype=int8) is not ported yet: the "
           "paged decode kernel reads no scale planes. ROADMAP B7 (B7 with "
           "int8 scale planes)")


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
    ``(payload, scale)`` with ``scale`` of ``x``'s shape, last axis 1 (a
    ones plane: f32 and bf16 carry no real scale)."""
    dtype = storage_dtype(dtype)
    if dtype == "int8":
        raise NotImplementedError(INT8_KV)
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)
    if dtype == "f32":
        return x, ones
    return x.to(torch.bfloat16), ones


def decode_rows(payload: torch.Tensor, scale: torch.Tensor,
                dtype: str) -> torch.Tensor:
    """Inverse of :func:`encode_rows`. f32 returns the payload OBJECT
    untouched."""
    del scale
    dtype = storage_dtype(dtype)
    if dtype == "int8":
        raise NotImplementedError(INT8_KV)
    if dtype == "f32":
        return payload
    return payload.to(torch.float32)
