"""Paged KV storage: the serving plane's decode memory hierarchy.

Port of ``multiverso_tpu/serving/paged.py``. The preallocated decode
caches (``serving/runners.py`` drain path, ``serving/continuous.py`` slot
engines) pin ``[layers, B, heads, bucket+max_new, dh]`` of device memory
per bucket; this module replaces that with a SHARED pool of fixed-size KV
pages (``[n_pages+1, layers, heads, page, dh]`` tensors on the pool's
device) plus per-slot page tables (int32 logical->physical maps), so the
memory *held* scales with actual context lengths.

Layout per slot at bucket ``S``, ``max_new`` ``N``, page size ``P``
(logical positions are the drain path's slot/position layout: prompt at
``[0, len)``, pad at ``[len, S)``, generated token ``t`` at ``S+t``):

* **shared-eligible pages**: fully inside the prompt region
  (``(p+1)*P <= S``) and holding real prompt tokens;
* **pad pages**: fully inside the prompt region but past ``len``: never
  attended, so UNBACKED (their page-table entries point at the reserved
  garbage page 0);
* **private pages**: any page overlapping the generated region, including
  the straddle page when ``S % P != 0``.

:func:`page_plan` and :class:`PagePlan` are the JAX package's host
arithmetic, copied so that the plans come out identical. Pages are
host-refcounted; physical page 0 is the garbage sink for unbacked logical
pages (its keys are always masked). On a card the decode step reads the
pool through B7 (``ops/attention.py::paged_decode_attn``), which takes
float32, bfloat16 or int8 pages. The scale planes ``ks``/``vs`` keep the
JAX layout: an int8 pool's per-row float32 scales, which B7 reads beside
each key and value row; ones for f32 and bf16, which carry no real
scale. Prefix sharing (``serving/prefix.py``) aliases the shared prompt
pages and copies a straddle page, payload and scales, on extend.

Telemetry: ``serve.kv.pages_used`` / ``serve.kv.pages_free`` gauges,
``serve.kv.page_evictions`` counter (prefix-store evictions returning
pages) and the ``serve.kv.pool_grows`` counter.
"""


from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from multiverso_tpu_torch.parallel.device import resolve_device
from multiverso_tpu_torch.serving.quant import (has_scale, storage_dtype,
                                                torch_dtype)
from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.utils.configure import flag_or
from multiverso_tpu_torch.utils.locks import make_lock
from multiverso_tpu_torch.utils.log import check, log

#: Reserved physical page: the garbage sink unbacked logical pages map to.
GARBAGE_PAGE = 0


def pages_of(n: int, page: int) -> int:
    """ceil(n / page) — logical pages covering ``n`` positions."""
    return -(-int(n) // int(page))


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Logical page layout for one decode slot (see module docstring).
    Indices are LOGICAL page numbers in ``[0, n_logical)``."""
    bucket: int
    length: int
    max_new: int
    page: int
    n_logical: int              # ceil((bucket+max_new)/page)
    n_prompt: int               # ceil(bucket/page): pages prefill scatters
    shared: Tuple[int, ...]     # fully-prompt, backed: shareable
    pad: Tuple[int, ...]        # fully-prompt, past len: unbacked
    private: Tuple[int, ...]    # overlap the gen region: slot-owned
    straddle: Optional[int]     # the private page holding prompt tail

    @property
    def n_backed(self) -> int:
        """Physical pages this slot holds (its HBM footprint in pages)."""
        return len(self.shared) + len(self.private)

    @property
    def straddle_has_prompt(self) -> bool:
        """Whether the straddle page carries REAL prompt tokens — when it
        does, a prefix sharer must copy-on-extend it; when the straddle
        is pure pad+gen its pre-decode contents are fully masked and a
        fresh page serves."""
        return self.straddle is not None \
            and self.straddle * self.page < self.length


def page_plan(length: int, bucket: int, max_new: int,
              page: int) -> PagePlan:
    """Classify every logical page of one slot. ``length`` is the real
    prompt length (>=1; pad rows plan as length 1, mirroring the
    kernels' ``maximum(lengths, 1)``)."""
    length = max(1, int(length))
    check(length <= bucket, f"prompt length {length} > bucket {bucket}")
    n_logical = pages_of(bucket + max_new, page)
    n_prompt = pages_of(bucket, page)
    shared: List[int] = []
    pad: List[int] = []
    private: List[int] = []
    straddle: Optional[int] = None
    for p in range(n_logical):
        lo, hi = p * page, (p + 1) * page
        if hi <= bucket:                      # fully inside prompt region
            (shared if lo < length else pad).append(p)
        else:                                 # touches the gen region
            private.append(p)
            if lo < bucket:
                straddle = p
    return PagePlan(bucket=bucket, length=length, max_new=max_new,
                    page=page, n_logical=n_logical, n_prompt=n_prompt,
                    shared=tuple(shared), pad=tuple(pad),
                    private=tuple(private), straddle=straddle)


class PagePool:
    """Device-resident KV page tensors + a host-side refcounting
    allocator.

    Tensors: ``kp``/``vp`` payload ``[capacity+1, layers, heads, page,
    dh]`` in the storage dtype, ``ks``/``vs`` scale planes ``[capacity+1,
    layers, heads, page, 1]`` (float32: int8's per-row scales, ones for
    f32 and bf16). Index 0 is the reserved
    garbage page. The tensors are OWNED by whoever is dispatching (the
    single batcher worker thread), which updates them in place; the
    allocator (:meth:`alloc`/:meth:`incref`/:meth:`decref`) is
    thread-safe. ``device`` defaults to the card (``-platform=cpu`` for
    the CPU)."""

    def __init__(self, capacity: int, layers: int, heads: int, page: int,
                 dh: int, kv_dtype: str = "f32",
                 device: Optional[torch.device] = None):
        check(capacity >= 1, "page pool needs at least one page")
        self.capacity = int(capacity)
        self.page = int(page)
        self.layers, self.heads, self.dh = int(layers), int(heads), int(dh)
        self.kv_dtype = storage_dtype(kv_dtype)
        self.device = resolve_device(flag_or("platform", ""), device)
        shape = (self.capacity + 1, layers, heads, page, dh)
        dt = torch_dtype(self.kv_dtype)
        self.kp = torch.zeros(shape, dtype=dt, device=self.device)
        self.vp = torch.zeros(shape, dtype=dt, device=self.device)
        sshape = shape[:-1] + (1,)
        self.ks = torch.ones(sshape, dtype=torch.float32, device=self.device)
        self.vs = torch.ones(sshape, dtype=torch.float32, device=self.device)
        self._lock = make_lock("serve.paged")
        self._free: List[int] = list(range(self.capacity, 0, -1))
        self._ref: Dict[int, int] = {}
        #: High-water mark of resident pages (per pool, unlike the
        #: process-wide gauge).
        self.max_used = 0
        self._g_used = gauge("serve.kv.pages_used")
        self._g_free = gauge("serve.kv.pages_free")
        self._c_grow = counter("serve.kv.pool_grows")
        self._c_evict = counter("serve.kv.page_evictions")
        self._publish_locked()

    # -- device tensors ------------------------------------------------------
    def arrays(self):
        """The current (kp, vp, ks, vs); steps update them in place."""
        return self.kp, self.vp, self.ks, self.vs

    def page_bytes(self) -> int:
        """Device bytes one physical page holds (K+V payload + the scale
        plane when the codec uses one)."""
        elems = self.layers * self.heads * self.page * self.dh
        payload = {"f32": 4, "bf16": 2, "int8": 1}[self.kv_dtype]
        scale = self.layers * self.heads * self.page * 4 \
            if has_scale(self.kv_dtype) else 0
        return 2 * (elems * payload + scale)

    def grow(self, new_capacity: int) -> None:
        """Enlarge the pool (drain-path correctness valve: a single batch
        that cannot fit must not deadlock). Copies the pool into larger
        tensors with fresh zero pages after it; rare, logged, counted.
        The copy is ordered after every step already queued on the
        device's stream."""
        with self._lock:
            if new_capacity <= self.capacity:
                return
            extra = int(new_capacity) - self.capacity

            def bigger(t, fill):
                out = torch.full((t.shape[0] + extra,) + t.shape[1:], fill,
                                 dtype=t.dtype, device=t.device)
                out[:t.shape[0]].copy_(t)
                return out

            self.kp = bigger(self.kp, 0)
            self.vp = bigger(self.vp, 0)
            self.ks = bigger(self.ks, 1)
            self.vs = bigger(self.vs, 1)
            self._free[:0] = list(range(self.capacity + extra,
                                        self.capacity, -1))
            self.capacity += extra
            self._c_grow.inc()
            log.warning("page pool grew to %d pages (a batch needed more "
                        "than the configured budget)", self.capacity)
            self._publish_locked()

    # -- allocator -----------------------------------------------------------
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def used_pages(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= int(n)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None when the pool cannot
        serve them — the caller QUEUES (admission keeps the request),
        never crashes. n=0 returns []."""
        n = int(n)
        with self._lock:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            self._publish_locked()
            return pages

    def incref(self, pages) -> None:
        with self._lock:
            for p in pages:
                if p == GARBAGE_PAGE:
                    continue
                check(p in self._ref, f"incref of unallocated page {p}")
                self._ref[p] += 1

    def decref(self, pages, evicting: bool = False) -> int:
        """Drop one reference per page; pages reaching zero return to
        the free list. Returns how many freed. ``evicting`` tags the
        frees as prefix-store evictions for the counter."""
        freed = 0
        with self._lock:
            for p in pages:
                if p == GARBAGE_PAGE:
                    continue
                check(p in self._ref, f"decref of unallocated page {p}")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    del self._ref[p]
                    self._free.append(p)
                    freed += 1
            if freed:
                self._publish_locked()
        if freed and evicting:
            self._c_evict.inc(freed)
        return freed

    def _publish_locked(self) -> None:
        used = self.capacity - len(self._free)
        self.max_used = max(self.max_used, used)
        self._g_used.set(used)
        self._g_free.set(len(self._free))

    def __repr__(self) -> str:  # debugging aid, not a contract
        return (f"PagePool(capacity={self.capacity}, page={self.page}, "
                f"dtype={self.kv_dtype}, used={self.used_pages()})")


def default_pool_pages(buckets, max_batch: int, max_new: int,
                       page: int, slack: int = 2) -> int:
    """The AUTO pool size: every bucket's engine fully backed at once
    (capacity parity with the preallocated layout — the flag exists to
    set a TIGHTER budget; auto never forces queueing where the old code
    would not have) plus ``slack`` batches of the largest bucket for the
    drain path's pipelined in-flight window."""
    per_engine = sum(pages_of(int(b) + max_new, page) * max_batch
                     for b in buckets)
    biggest = max(pages_of(int(b) + max_new, page) for b in buckets)
    return per_engine + slack * biggest * max_batch
