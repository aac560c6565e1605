"""Model runners behind the serving batcher.

Port of ``multiverso_tpu/serving/runners.py``: the :class:`ServingRunner`
protocol, the two row-lookup runners and :class:`AttentionLMRunner`.

* :class:`SparseLookupRunner` serves rows straight from a LIVE
  :class:`~multiverso_tpu_torch.core.table.ServerStore` through
  ``ServerStore.read_rows``: the gather is issued under the store's lock
  on the stream its Adds run on, so a batch is one consistent table and
  the values are bitwise a direct ``get_rows`` of the same rows at the
  same clock.
* :class:`ReplicaLookupRunner` serves the same lookup from a FROZEN
  checkpoint replica (``serving/replica.py``), hot-swapped between
  batches.

Both gather float32 rows with B1 (``ops/rows.gather_rows``) on a card,
whether or not the table is ``use_pallas``, with the ids clipped into
range first: B1 is bitwise the JAX package's ``jnp.take(mode="clip")``. Replica
tables stored as bf16 or int8 are read by a dequant gather in torch ops
(gather, ``.float()``, times the gathered per-row scales), in the JAX
package's order; the JAX package computes that in XLA, not Pallas. The
JAX runners' ``jit_cache_size`` has no counterpart: the port compiles
nothing per bucket.

:class:`AttentionLMRunner` is greedy decode for an
``attention_lm`` checkpoint. The batcher hands a bucket-padded
``(max_batch, bucket)`` prompt matrix + per-row lengths; the runner
prefills the prompts (plain causal attention, one pass), then runs a
Python loop of single-token steps (the JAX package's ``lax.scan``)
attending into the KV cache, and returns ``[max_batch, max_new]`` greedy
tokens.

Two cache layouts, as in the JAX package:

* preallocated (default): one ``[layers, B, heads, bucket+max_new, dh]``
  K and V cache per bucket, updated in place call over call (the JAX
  package donates it back to itself);
* paged (``paged=True``): one shared :class:`~multiverso_tpu_torch.
  serving.paged.PagePool` and a per-row page table. The step encodes the
  new token's K/V in the pool's storage codec (``kv_dtype``: f32, bf16,
  or int8 with per-row scales, ``serving/quant.py``), writes payload and
  scale into its page, then reads the pool through
  ``ops/attention.py::paged_decode_attn``: B7 on a card (int8 pages
  dequantized by their scale planes inside it), the plain gather
  formulation on the CPU.

The decode math lives here once (:func:`prefill`, :func:`decode_step`,
the two attention reads) and ``serving/continuous.py`` calls it too: the
JAX package writes it out in each of its four step functions. It keeps
the JAX package's math: the port's ``_ln``/``_posenc``, tanh-GELU, the
mask ``key_slot < len`` or ``bucket <= key_slot <= bucket + t``, and the
slot/position decoupling (generated token ``t`` sits at cache slot
``bucket + t`` and position ``len + t``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch.interop import check_attention_lm_params
from multiverso_tpu_torch.models.attention_lm import (_ln, _posenc,
                                                      dense_param_shapes)
from multiverso_tpu_torch.core.table import host_array
from multiverso_tpu_torch.ops.attention import paged_decode_attn
from multiverso_tpu_torch.ops.rows import gather_rows
from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.serving.cache import HotRowCache
from multiverso_tpu_torch.serving.device_clock import DeviceClock
from multiverso_tpu_torch.serving.paged import PagePool, page_plan, pages_of
from multiverso_tpu_torch.serving.quant import (encode_rows, has_scale,
                                                storage_dtype)
from multiverso_tpu_torch.telemetry.sketch import record_keys
from multiverso_tpu_torch.utils.configure import flag_or
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check

try:                     # 3.8+ typing.Protocol
    from typing import Protocol
except ImportError:      # pragma: no cover - ancient interpreter
    Protocol = object

Params = Dict[str, torch.Tensor]


class ServingRunner(Protocol):
    """What the batcher needs from a model runner."""

    name: str
    payload_dtype: np.dtype
    pad_id: int

    def run(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """``batch`` is ``(max_batch, bucket)`` padded payloads, ``lengths``
        the real payload length per row (0 = padding row). Returns an
        array whose leading dim is ``max_batch``."""
        ...

    def slice_result(self, out: np.ndarray, i: int, length: int):
        """Extract request ``i``'s reply from the batch result."""
        ...

    # Optional two-phase contract (serving/pipeline.py): ``dispatch``
    # queues the device work WITHOUT syncing and returns an opaque
    # handle; ``collect(handle)`` blocks and returns what ``run`` would
    # have. Runners that implement both ride the depth-N dispatch
    # pipeline; ``run`` stays as dispatch+collect for warmup and the
    # serialized path. ``try_cached(payload)`` (optional) may answer a
    # request host-side at admission; None means "take the device path".
    # ``token_times(handle)`` (optional) returns the host time the batch's
    # first tokens were ready and the device time per further token.


# ---------------------------------------------------------------------------
# The decode math, shared by the drain runner and the continuous batcher.
# ---------------------------------------------------------------------------
def attn_scale(dh: int) -> float:
    """``1 / sqrt(dh)`` rounded to float32, as the JAX step computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _mlp(params: Params, i: int, x: torch.Tensor) -> torch.Tensor:
    h = _ln(x)
    return x + F.gelu(h @ params[f"mlp_in_{i}"], approximate="tanh") \
        @ params[f"mlp_out_{i}"]


def prefill(params: Params, cfg, tokens: torch.Tensor,
            lengths: torch.Tensor, pe: torch.Tensor,
            store: Callable[[int, torch.Tensor, torch.Tensor], None]
            ) -> torch.Tensor:
    """The full causal pass over right-padded prompts ``tokens`` [B, S]:
    ``store(i, k, v)`` receives layer ``i``'s keys and values
    ``[B, H, S, dh]``; returns each row's first greedy token [B] int32
    (the argmax at position ``lengths - 1``; ``lengths`` >= 1)."""
    B, S = tokens.shape
    H, D = cfg.heads, cfg.dim
    dh = D // H
    scale = attn_scale(dh)

    def heads_of(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    x = params["embed"][tokens.long()] + pe[None, :S]
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=x.device).tril()[None, None]
    for i in range(cfg.layers):
        h = _ln(x)
        q, k, v = (heads_of(t) for t in
                   torch.split(h @ params[f"qkv_{i}"], D, dim=-1))
        store(i, k, v)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")),
                              dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        x = x + o.transpose(1, 2).reshape(B, S, D) @ params[f"attn_out_{i}"]
        x = _mlp(params, i, x)
    logits = _ln(x) @ params["out"]                         # [B, S, V]
    rows = torch.arange(B, device=x.device)
    return torch.argmax(logits[rows, lengths.long() - 1], dim=-1) \
        .to(torch.int32)


def decode_step(params: Params, cfg, tok: torch.Tensor, pos: torch.Tensor,
                pe: torch.Tensor,
                attend: Callable[[int, torch.Tensor, torch.Tensor,
                                  torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """One cached-attention step for every row: ``tok`` [B] is the token
    on deck at position ``pos`` [B]; ``attend(i, q, k, v)`` (each
    [B, H, dh]) writes layer ``i``'s new K/V into the cache and returns
    the attention output [B, H, dh]. Returns the next greedy token [B]
    int32."""
    B = tok.shape[0]
    H, D = cfg.heads, cfg.dim
    dh = D // H
    x = params["embed"][tok.long()] + pe[pos.long()]
    for i in range(cfg.layers):
        h = _ln(x)
        q, k, v = (t.reshape(B, H, dh) for t in
                   torch.split(h @ params[f"qkv_{i}"], D, dim=-1))
        o = attend(i, q, k, v)
        x = x + o.reshape(B, D) @ params[f"attn_out_{i}"]
        x = _mlp(params, i, x)
    logits = _ln(x) @ params["out"]                         # [B, V]
    return torch.argmax(logits, dim=-1).to(torch.int32)


def key_mask(n_keys: int, bucket: int, lengths: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """[B, n_keys]: key slot ``r`` is valid iff ``r < len`` (the prompt)
    or ``bucket <= r <= bucket + t`` (generated so far)."""
    key_slot = torch.arange(n_keys, device=lengths.device)[None, :]
    return (key_slot < lengths[:, None].long()) | \
        ((key_slot >= bucket) & (key_slot <= bucket + t[:, None].long()))


def cache_read(q: torch.Tensor, ck_i: torch.Tensor, cv_i: torch.Tensor,
               mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The preallocated cache's read: q [B, H, dh] over ``ck_i``/``cv_i``
    [B, H, K, dh] with ``mask`` [B, K]. Plain matmul and softmax in both
    packages (no TPU kernel computes it)."""
    scores = torch.einsum("bhd,bhkd->bhk", q, ck_i) * scale
    probs = torch.softmax(
        scores.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, cv_i)


def paginate(t: torch.Tensor, page: int) -> torch.Tensor:
    """[B, H, S, dh] -> [B * ceil(S/page), H, page, dh], the page-major
    scatter form; positions past S pad with zeros (the straddle page's
    untouched generated region)."""
    B, H, S, dh = t.shape
    n_pp = pages_of(S, page)
    w = F.pad(t, (0, 0, 0, n_pp * page - S))
    w = w.transpose(1, 2).reshape(B, n_pp, page, H, dh)
    return w.transpose(2, 3).reshape(B * n_pp, H, page, dh)


def write_prompt_pages(pool, i: int, pages: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, page: int, kv_dtype: str) -> None:
    """Store layer ``i``'s prompt K/V [B, H, S, dh] in the codec
    ``kv_dtype``, page-major (:func:`paginate`), into the physical
    ``pages`` [B * ceil(S/page)] (long) of ``pool`` = ``(kp, vp, ks, vs)``,
    payload and, for int8, scale, in place: the JAX prefill's
    ``encode_rows`` then ``.at[pages, i].set``."""
    kp, vp, ks, vs = pool
    for pay, sc, x in ((kp, ks, k), (vp, vs, v)):
        q, scale = encode_rows(paginate(x, page), kv_dtype)
        pay[:, i][pages] = q
        if has_scale(kv_dtype):
            sc[:, i][pages] = scale


def paged_write(pool, i: int, gphys: torch.Tensor, goff: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, kv_dtype: str) -> None:
    """Store the new token's K/V [B, H, dh] of every row in the codec
    ``kv_dtype`` at row ``goff`` of page ``gphys`` (both [B]) of layer
    ``i`` of ``pool`` = ``(kp, vp, ks, vs)``, payload and, for int8,
    scale, in place."""
    kp, vp, ks, vs = pool
    heads = torch.arange(k.shape[1], device=k.device)[None, :]
    idx = (gphys.long()[:, None], heads, goff.long()[:, None])
    for pay, sc, x in ((kp, ks, k), (vp, vs, v)):
        q, scale = encode_rows(x, kv_dtype)
        pay[:, i][idx] = q
        if has_scale(kv_dtype):
            sc[:, i][idx] = scale


def paged_read(pool, i: int, q: torch.Tensor, ptab: torch.Tensor,
               lengths: torch.Tensor, t: torch.Tensor, *, bucket: int,
               page: int, scale: float) -> torch.Tensor:
    """Layer ``i``'s attention read of ``pool`` = ``(kp, vp, ks, vs)``:
    B7 on a card (int8 pages with their scale planes), its plain version
    on the CPU."""
    kp, vp, ks, vs = pool
    return paged_decode_attn(q, kp[:, i], vp[:, i], ptab, lengths, t,
                             bucket=bucket, page=page, scale=scale,
                             ks=ks[:, i], vs=vs[:, i])


# ---------------------------------------------------------------------------
# Row lookups: a live table and a frozen checkpoint replica.
# ---------------------------------------------------------------------------
def _batch_keys(batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The REAL keys of a padded batch (pad rows/columns excluded) — what
    the traffic sketch must see: pad id 0 is a legitimate row id, so the
    stream is cut by lengths, never by value."""
    parts = [batch[i, :int(n)] for i, n in enumerate(lengths) if n]
    if not parts:
        return np.empty(0, dtype=batch.dtype)
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _clipped_ids(flat: np.ndarray, rows: int, device) -> torch.Tensor:
    """Row ids clipped into ``[0, rows)`` on the host (``mode="clip"``:
    a pad id gathers a real row, which the per-request slice discards),
    as int32 on ``device``."""
    ids = np.clip(flat, 0, rows - 1).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def _dequant_gather(data: torch.Tensor, scale: Optional[torch.Tensor],
                    ids: torch.Tensor) -> torch.Tensor:
    """The gather of a quantized replica table with its decode: rows
    gathered, widened to float32, int8 rows times their gathered per-row
    scales (the JAX package's order)."""
    idx = ids.to(torch.int64)
    rows = data.index_select(0, idx).to(torch.float32)
    if scale is not None:
        rows = rows * scale.index_select(0, idx)
    return rows


class SparseLookupRunner:
    """Row lookup served from a live ServerStore shard.

    ``row_offset`` maps GLOBAL row ids to this shard's local rows (the
    same offset arithmetic the DCN tables route by); ``clock_fn`` (e.g.
    ``sync_coordinator.clock``) stamps each batch with the snapshot
    version it was served at."""

    name = "lookup"
    payload_dtype = np.int32
    pad_id = 0

    def __init__(self, store, row_offset: int = 0,
                 clock_fn: Optional[Callable[[], Tuple[float, float]]]
                 = None, cache: Optional[HotRowCache] = None):
        check(len(store.padded_shape) == 2,
              "SparseLookupRunner serves 2-D row tables")
        self.store = store
        self.row_offset = int(row_offset)
        self._clock_fn = clock_fn
        self.cache = cache
        self.last_clock: float = -1.0

    def current_clock(self) -> float:
        """The live BSP clock (host read, no device work) — what stamps
        cache entries and decides cache freshness."""
        if self._clock_fn is None:
            return -1.0
        return float(self._clock_fn()[0])

    def try_cached(self, payload: np.ndarray) -> Optional[np.ndarray]:
        """Host-side answer for a fully-hot request (every key cached
        within the staleness bound); None sends it down the device path.

        A LIVE table without a clock (async mode, no SyncCoordinator)
        never serves from cache: with no version to age entries by,
        training writes would be masked forever — the staleness bound
        is only meaningful against the BSP clock."""
        if self.cache is None or payload.size == 0 \
                or self._clock_fn is None:
            return None
        return self.cache.get_rows(payload, self.current_clock())

    # -- two-phase dispatch (serving/pipeline.py contract) -----------------
    def dispatch(self, batch: np.ndarray, lengths: np.ndarray):
        # Stamp BEFORE the gather: the snapshot the guarded gather reads
        # is at-or-after this clock, so a cache entry is never stamped
        # NEWER than its data (a tick landing mid-dispatch would
        # otherwise relabel clock-c rows as c+1, and a staleness-0 hit
        # would then serve stale bytes as fresh).
        clock = self.current_clock()
        # Device-path half of the key stream (cache hits record at the
        # cache).
        keys = _batch_keys(batch, lengths)
        record_keys("serve.lookup", keys,
                    keys.size * int(self.store.padded_shape[1]) * 4)
        # The store clips the ids into range and gathers under its lock
        # (B1 for a float32 table).
        values = self.store.read_rows(
            (batch.astype(np.int64) - self.row_offset).reshape(-1))
        return values, clock, batch, lengths.copy()

    def collect(self, handle) -> np.ndarray:
        values, clock, batch, lengths = handle
        values = host_array(values)         # the device sync
        out = values.reshape(batch.shape[0], batch.shape[1], -1)
        # FIFO collection order (pipeline contract) keeps last_clock
        # monotone with delivery order.
        self.last_clock = clock
        # Populate only under a clock: clockless live entries could
        # never be aged out (see try_cached), so caching them is waste.
        if self.cache is not None and self._clock_fn is not None:
            for i in range(len(lengths)):
                n = int(lengths[i])
                if n:
                    self.cache.put_rows(batch[i, :n], out[i, :n], clock)
        return out

    def run(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch(batch, lengths))

    def slice_result(self, out: np.ndarray, i: int, length: int):
        return out[i, :length]

    def clock(self) -> float:
        return self.last_clock


class ReplicaLookupRunner:
    """Row lookup from a frozen checkpoint replica (``replica.py``).

    Captures one replica snapshot per batch, so a hot-swap between
    batches is atomic from the client's point of view and NEVER blocks:
    readers of the old snapshot finish against the old tensors."""

    name = "replica_lookup"
    payload_dtype = np.int32
    pad_id = 0

    def __init__(self, replica, table: str,
                 cache: Optional[HotRowCache] = None):
        self.replica = replica
        self.table = table
        self.cache = cache
        self.last_clock: float = -1.0

    def current_clock(self) -> float:
        """The replica's checkpoint step: advancing on hot-swap, so a
        swap invalidates older cache entries by arithmetic."""
        return float(self.replica.snapshot().step)

    def try_cached(self, payload: np.ndarray) -> Optional[np.ndarray]:
        if self.cache is None or payload.size == 0:
            return None
        return self.cache.get_rows(payload, self.current_clock())

    # -- two-phase dispatch (serving/pipeline.py contract) -----------------
    def dispatch(self, batch: np.ndarray, lengths: np.ndarray):
        snap = self.replica.snapshot()
        data, scale = snap.storage(self.table)
        keys = _batch_keys(batch, lengths)
        record_keys("serve.lookup", keys,
                    keys.size * int(data.shape[1]) * 4)
        ids = _clipped_ids(batch.reshape(-1), data.shape[0], data.device)
        if scale is None and data.dtype == torch.float32:
            # f32 storage: EXACTLY the table's rows (B1), bitwise the
            # checkpoint.
            values = gather_rows(data, ids)
        else:
            values = _dequant_gather(data, scale, ids)
        return values, float(snap.step), batch, lengths.copy()

    def collect(self, handle) -> np.ndarray:
        values, step, batch, lengths = handle
        values = host_array(values)         # the device sync
        out = values.reshape(batch.shape[0], batch.shape[1], -1)
        self.last_clock = step
        if self.cache is not None:
            for i in range(len(lengths)):
                n = int(lengths[i])
                if n:
                    self.cache.put_rows(batch[i, :n], out[i, :n], step)
        return out

    def run(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch(batch, lengths))

    def slice_result(self, out: np.ndarray, i: int, length: int):
        return out[i, :length]

    def clock(self) -> float:
        return self.last_clock


class AttentionLMRunner:
    """Greedy decode for an ``attention_lm`` checkpoint.

    ``params`` is the JAX runner's argument, a dict of float32 numpy
    arrays under the JAX names (``embed``, ``qkv_i``, ``attn_out_i``,
    ``mlp_in_i``, ``mlp_out_i``, ``out``), checked by name, shape and
    dtype before anything is moved to ``device`` (the card unless
    ``device`` or ``-platform=cpu`` says otherwise). ``kv_dtype``
    "f32", "bf16" or "int8" (the last two need ``paged``)."""

    name = "attention_lm"
    payload_dtype = np.int32
    pad_id = 0

    def __init__(self, params: Dict[str, np.ndarray], cfg,
                 max_new: int = 16, max_batch: int = 8,
                 paged: bool = False, kv_dtype: str = "f32",
                 page: int = 16, pool_pages: Optional[int] = None,
                 device: Optional[torch.device] = None):
        check(cfg.moe_experts == 0 and cfg.pipeline_stages == 0,
              "serving decode supports the flat dense attention_lm layout")
        self.cfg = cfg
        self.max_new = int(max_new)
        self.max_batch = int(max_batch)
        self.paged = bool(paged)
        self.kv_dtype = storage_dtype(kv_dtype)
        self.page = int(page)
        self.pool_pages = pool_pages
        check(self.kv_dtype == "f32" or self.paged,
              "quantized KV storage requires the paged cache")
        self.device = resolve_device(flag_or("platform", ""), device)
        self._params = self._load(params)
        self._params_lock = make_lock("serve.runner.params")
        self._params_version = 0
        self.device_clock = DeviceClock(self.device)
        # bucket -> preallocated (ck, cv): [L, B, H, bucket+max_new, dh]
        self._caches: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._pe: Dict[int, torch.Tensor] = {}
        # Paged drain mode: one shared pool across buckets.
        self._pool: Optional[PagePool] = None

    def _load(self, params: Dict[str, np.ndarray]) -> Params:
        check_attention_lm_params(params, dense_param_shapes(self.cfg))
        return {k: torch.tensor(np.asarray(v), device=self.device)
                for k, v in params.items()}

    def swap_params(self, params: Dict[str, np.ndarray]) -> None:
        """Hot-swap weights (replica handoff): the next batch serves the
        new checkpoint."""
        new = self._load(params)
        with self._params_lock:
            self._params = new
            self._params_version += 1

    def params_ref(self) -> Params:
        """The current weights under the swap lock: what the continuous
        engine binds per dispatch (a hot-swap lands at the next step
        boundary, never mid-step)."""
        with self._params_lock:
            return self._params

    def params_versioned(self) -> Tuple[Params, int]:
        """``(params, version)`` atomically under the swap lock; the
        version is monotonic."""
        with self._params_lock:
            return self._params, self._params_version

    def posenc(self, bucket: int) -> torch.Tensor:
        """The ``[bucket + max_new, dim]`` position table of a bucket."""
        pe = self._pe.get(bucket)
        if pe is None:
            pe = self._pe[bucket] = _posenc(bucket + self.max_new,
                                            self.cfg.dim, self.device)
        return pe

    def cache_shape(self, bucket: int, batch: int) -> Tuple[int, ...]:
        cfg = self.cfg
        return (cfg.layers, batch, cfg.heads, bucket + self.max_new,
                cfg.dim // cfg.heads)

    def _cache_for(self, bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
        cached = self._caches.get(bucket)
        if cached is None:
            shape = self.cache_shape(bucket, self.max_batch)
            cached = self._caches[bucket] = (
                torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))
        return cached

    def _tensors(self, batch: np.ndarray, lengths: np.ndarray):
        tokens = torch.tensor(np.asarray(batch, np.int32), device=self.device)
        lens = torch.tensor(np.maximum(np.asarray(lengths, np.int32), 1),
                            device=self.device)      # pad rows: row 0
        return tokens, lens

    def _decode(self, params: Params, tokens: torch.Tensor,
                lengths: torch.Tensor, n_keys: int, write, attend) -> tuple:
        """Prefill + ``max_new - 1`` steps over ``n_keys`` cache slots;
        ``write(i, k, v)`` stores the prompt's K/V and ``attend(t, tt,
        mask, i, q, k, v)`` is step ``t``'s cache write and read (``tt``
        is ``t`` for every row). Returns ([B, max_new] int32 tokens, the
        first-token mark, the last-token mark)."""
        B, S = tokens.shape
        pe = self.posenc(S)
        clock = self.device_clock
        tok = prefill(params, self.cfg, tokens, lengths, pe, write)
        first_mark = last_mark = clock.mark()
        toks = [tok]
        for t in range(self.max_new - 1):
            tt = torch.full((B,), t, dtype=torch.int32, device=self.device)
            mask = key_mask(n_keys, S, lengths, tt)
            tok = decode_step(params, self.cfg, tok, lengths + t, pe,
                              functools.partial(attend, t, tt, mask))
            toks.append(tok)
            last_mark = None
        if last_mark is None:
            last_mark = clock.mark()
        return torch.stack(toks, dim=1), first_mark, last_mark

    def _decode_prealloc(self, params: Params, tokens: torch.Tensor,
                         lengths: torch.Tensor, ck: torch.Tensor,
                         cv: torch.Tensor) -> tuple:
        """The preallocated drain decode into ``ck``/``cv`` (in place)."""
        S = tokens.shape[1]
        scale = attn_scale(self.cfg.dim // self.cfg.heads)

        def write(i, k, v):
            ck[i, :, :, :S] = k
            cv[i, :, :, :S] = v

        def attend(t, tt, mask, i, q, k, v):
            ck[i, :, :, S + t] = k
            cv[i, :, :, S + t] = v
            return cache_read(q, ck[i], cv[i], mask, scale)

        return self._decode(params, tokens, lengths, S + self.max_new,
                            write, attend)

    def _decode_paged(self, params: Params, tokens: torch.Tensor,
                      lengths: torch.Tensor, ptab: torch.Tensor,
                      pool: PagePool) -> tuple:
        """The paged drain decode: prompt K/V encoded and scattered into
        the pages of ``ptab``'s prompt region, then each step's K/V into
        its page and the read through ``paged_decode_attn`` (B7 on a
        card)."""
        B, S = tokens.shape
        P = self.page
        n_pp = pages_of(S, P)
        scale = attn_scale(self.cfg.dim // self.cfg.heads)
        prompt_pages = ptab[:, :n_pp].reshape(-1).long()

        arrays = pool.arrays()

        def write(i, k, v):
            write_prompt_pages(arrays, i, prompt_pages, k, v, P,
                               self.kv_dtype)

        def attend(t, tt, mask, i, q, k, v):
            gphys = ptab[:, (S + t) // P]
            goff = torch.full_like(gphys, (S + t) % P)
            paged_write(arrays, i, gphys, goff, k, v, self.kv_dtype)
            return paged_read(arrays, i, q, ptab, lengths, tt, bucket=S,
                              page=P, scale=scale)

        return self._decode(params, tokens, lengths, ptab.shape[1] * P,
                            write, attend)

    # -- paged drain decode --------------------------------------------------
    def _pool_for(self, need: int) -> PagePool:
        cfg = self.cfg
        if self._pool is None:
            # An explicit -serve_kv_pages budget is honored EXACTLY
            # (growth is the logged correctness valve); auto sizes for
            # two in-flight batches of the first-seen shape.
            capacity = int(self.pool_pages) if self.pool_pages \
                else max(2 * need, 1)
            self._pool = PagePool(capacity, cfg.layers, cfg.heads,
                                  self.page, cfg.dim // cfg.heads,
                                  self.kv_dtype, device=self.device)
        return self._pool

    def _dispatch_paged(self, batch: np.ndarray, lengths: np.ndarray):
        bucket = batch.shape[1]
        N, P = self.max_new, self.page
        plans = [page_plan(int(n), bucket, N, P) for n in lengths]
        G = pages_of(bucket + N, P)
        need = sum(p.n_backed for p in plans)
        pool = self._pool_for(need)
        pages = pool.alloc(need)
        if pages is None:
            # The drain path has no admission queue to lean on: a batch
            # that cannot fit GROWS the pool (bounded by the dispatch
            # pipeline depth) instead of deadlocking or shedding.
            pool.grow(pool.capacity + need)
            pages = pool.alloc(need)
            check(pages is not None, "page pool exhausted after growth")
        ptab = np.zeros((batch.shape[0], G), dtype=np.int32)
        it = iter(pages)
        for b, plan in enumerate(plans):
            for logical in (*plan.shared, *plan.private):
                ptab[b, logical] = next(it)
        params = self.params_ref()
        try:
            tokens, lens = self._tensors(batch, lengths)
            out, first, last = self._decode_paged(
                params, tokens, lens, torch.tensor(ptab, device=self.device),
                pool)
        except Exception:
            pool.decref(pages)      # a failed launch must not leak pages
            raise
        return out, first, last, pages

    # -- two-phase dispatch (serving/pipeline.py contract) -----------------
    def dispatch(self, batch: np.ndarray, lengths: np.ndarray):
        """Queue the decode on the device WITHOUT syncing. Back-to-back
        dispatches serialize on the device stream (batch k+1's prefill
        writes the cache after batch k's steps have read it); the
        pipeline overlaps host work with device work."""
        if self.paged:
            return self._dispatch_paged(batch, lengths)
        ck, cv = self._cache_for(batch.shape[1])
        tokens, lens = self._tensors(batch, lengths)
        out, first, last = self._decode_prealloc(self.params_ref(), tokens,
                                                 lens, ck, cv)
        return out, first, last, None

    def collect(self, handle) -> np.ndarray:
        out, _, _, pages = handle
        values = out.cpu().numpy()          # the device sync
        if pages is not None:
            self._pool.decref(pages)        # pages free once the batch
        return values                       # is off the device

    def token_times(self, handle) -> Tuple[float, Optional[float]]:
        """(host time the batch's first tokens were ready, device ms per
        further token), read after :meth:`collect`."""
        _, first, last, _ = handle
        clock = self.device_clock
        t_first = clock.host_time(first)
        if self.max_new < 2:
            return t_first, None
        return t_first, (clock.host_time(last) - t_first) * 1e3 \
            / (self.max_new - 1)

    def run(self, batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch(batch, lengths))

    def slice_result(self, out: np.ndarray, i: int, length: int):
        del length                     # every request gets max_new tokens
        return out[i]

    def clock(self) -> float:
        return -1.0

    def pool_high_water(self) -> int:
        """Most pages the paged drain pool has held at once (0 when
        preallocated)."""
        return self._pool.max_used if self._pool is not None else 0
