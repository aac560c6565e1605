"""Carry parameters from the JAX package into the port.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of its
device arrays), so this module needs neither JAX nor the JAX package:

* :func:`load_store_payload` takes a ``ServerStore.store_state()`` payload
  of the JAX package (``data`` plus ``state/<leaf>`` entries, logical
  extents) and loads it into a port ``ServerStore`` — the same format the
  port's own ``store_state`` writes;
* :func:`load_word2vec_tables` writes the four word2vec table arrays
  (input/output embeddings and their AdaGrad accumulators) into a port
  ``Word2Vec``; bfloat16 embeddings arrive as float32 values, as uint16
  bit patterns or as the JAX package's own bfloat16 arrays, and load bit
  for bit;
* :func:`load_attention_lm_params` writes the JAX ``AttentionLM.params``
  into a port ``AttentionLM``; :func:`check_attention_lm_params` is its
  check, which the serving runner applies to the same dict.

Each checks names, shapes and dtypes, so a mismatched pair of models
fails loudly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from multiverso_tpu_torch.utils.log import check


def load_store_payload(store, payload: Mapping[str, np.ndarray]) -> None:
    """Load a JAX package ``store_state()`` payload into a port store.
    Each entry crosses in its own dtype: a bfloat16 table's ``data`` and
    its bfloat16 state leaves (momentum_sgd's ``smooth``) as bfloat16
    arrays, uint16 bit patterns or float32 values that are exactly
    bfloat16, bit for bit; float32 leaves (AdaGrad's ``g2``, FTRL's ``z``
    and ``n``, DC-ASGD's ``backup`` and ``m``) as float32."""
    import torch

    check("data" in payload, "store payload needs a 'data' entry")
    loaded = {}
    for key, values in payload.items():
        check(key == "data" or (key.startswith("state/")
                                and key[len("state/"):] in store.state),
              f"payload entry {key!r} has no counterpart in table "
              f"'{store.name}' (leaves {sorted(store.state)})")
        live = (store.data if key == "data"
                else store.state[key[len("state/"):]])
        values = np.asarray(values)
        if live.dtype == torch.bfloat16:
            values = _bfloat16_values(f"{store.name}/{key}", values)
        elif live.dtype == torch.float32:
            check(values.dtype == np.float32,
                  f"{store.name}/{key}: dtype {values.dtype} != float32")
        loaded[key] = np.array(values, copy=True)
    store.load_state(loaded)


def _bfloat16_values(name: str, values: np.ndarray) -> np.ndarray:
    """A bfloat16 table's values as float32 (an exact widening): from
    uint16 bit patterns, from an array of a numpy dtype named
    ``bfloat16`` (by its bits), or from float32 values that are exactly
    bfloat16."""
    import torch

    if values.dtype == np.uint16 or values.dtype.name == "bfloat16":
        bits = np.array(values, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    check(values.dtype == np.float32,
          f"{name}: dtype {values.dtype} is not float32, uint16 bit "
          "patterns or bfloat16")
    t = torch.from_numpy(np.array(values, copy=True))
    check(bool((t.bfloat16().float() == t).all()),
          f"{name}: float32 values that are not bfloat16 would be rounded")
    return values


def load_word2vec_tables(w2v, w_in: np.ndarray, w_out: np.ndarray,
                         g_in: np.ndarray, g_out: np.ndarray) -> None:
    """Write the four word2vec tables of the JAX package into ``w2v``,
    bit for bit: float32 tables as float32, and bfloat16 embeddings
    (``param_dtype="bfloat16"``) as float32 values, uint16 bit patterns
    or bfloat16 arrays."""
    import torch

    for table, values in ((w2v.input_table, w_in), (w2v.output_table, w_out),
                          (w2v.adagrad_in, g_in), (w2v.adagrad_out, g_out)):
        values = np.asarray(values)
        check(values.shape == table.store.logical_shape,
              f"{table.name}: shape {values.shape} != "
              f"{table.store.logical_shape}")
        if table.store.torch_dtype == torch.bfloat16:
            values = _bfloat16_values(table.name, values)
        check(values.dtype == np.float32,
              f"{table.name}: dtype {values.dtype} != float32")
        table.store.load_state({"data": values})


def check_attention_lm_params(params: Mapping[str, np.ndarray],
                              shapes: Mapping[str, tuple]) -> None:
    """The JAX package's attention-LM parameters (``np.asarray`` of each
    leaf) against the names and shapes a port model expects: the same
    names, the same ``[in, out]`` layouts, float32. Raises before
    anything is moved."""
    missing = sorted(set(shapes) - set(params))
    extra = sorted(set(params) - set(shapes))
    check(not missing and not extra,
          f"attention LM parameter names differ: missing {missing}, "
          f"unexpected {extra}")
    for name, value in params.items():
        value = np.asarray(value)
        check(value.shape == tuple(shapes[name]),
              f"{name}: shape {value.shape} != {tuple(shapes[name])}")
        check(value.dtype == np.float32,
              f"{name}: dtype {value.dtype} != float32")


def load_attention_lm_params(lm, params: Mapping[str, np.ndarray]) -> None:
    """Write the JAX package's ``AttentionLM.params`` (``np.asarray`` of
    each leaf) into the port's ``AttentionLM`` after
    :func:`check_attention_lm_params`. Adam's state is not carried."""
    import torch

    mine = dict(lm.named_parameters())
    check_attention_lm_params(params,
                              {n: tuple(p.shape) for n, p in mine.items()})
    with torch.no_grad():
        for name, value in params.items():
            mine[name].copy_(torch.as_tensor(np.asarray(value)))
