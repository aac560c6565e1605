"""Prefix-cache reuse: requests sharing a prompt share prefill work and
KV pages (the decode memory hierarchy's second stage).

Port of ``multiverso_tpu/serving/prefix.py``, host-only: a ref-counted
LRU map ``(bucket, prompt-token hash) -> prefill output``, where the
output is (a) the first greedy token (greedy decode is deterministic, so
an identical prompt under identical weights produces it bit for bit) and
(b) the physical ids of the prompt's KV pages in a
:class:`~multiverso_tpu_torch.serving.paged.PagePool`.

On a hit the joining slot ALIASES the shared prompt pages (written once at
prefill and never again, ``serving/paged.py``), copies the straddle page
when it carries real prompt tokens (copy-on-extend, payload and scale
planes), allocates only private generated pages, and skips the prefill
launch. The batcher probes at claim time (``ContinuousBatcher.
_reserve_paged``), so the pin happens before the request can be joined:
an eviction between claim and join never frees pages out from under a
matched request.

Weights discipline: entries record the weights token they were
prefilled under (the runner's monotonic swap version); a checkpoint
hot-swap changes it, and the next probe or publish invalidates the whole
store.

Telemetry: ``serve.prefix.hits`` / ``serve.prefix.misses`` /
``serve.prefix.shared_pages`` / ``serve.prefix.prefill_skipped``
counters and the ``serve.prefix.entries`` gauge.
"""

from __future__ import annotations

import collections
import hashlib
from typing import List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.serving.paged import GARBAGE_PAGE, PagePool
from multiverso_tpu_torch.telemetry import counter, gauge
from multiverso_tpu_torch.utils.locks import make_lock


def prompt_key(tokens: np.ndarray, bucket: int) -> Tuple[int, bytes]:
    """Store key: bucket + sha1 of the prompt bytes (the hash buckets;
    the entry's stored tokens break collisions exactly)."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return (int(bucket), hashlib.sha1(t.tobytes()).digest())


class PrefixEntry:
    """One cached prefill: the shared prompt pages (physical ids aligned
    with the plan's ``shared`` logical indices), the straddle page the
    donor extends into (its prompt-region bytes stay valid because gen
    writes only positions ``>= bucket``), and the first greedy token."""

    __slots__ = ("tokens", "bucket", "length", "first_token",
                 "shared_pages", "straddle_page", "params_token", "pinned")

    def __init__(self, tokens: np.ndarray, bucket: int, first_token: int,
                 shared_pages: Tuple[int, ...],
                 straddle_page: Optional[int], params_token: int):
        self.tokens = np.array(tokens, np.int32, copy=True)
        self.bucket = int(bucket)
        self.length = int(self.tokens.shape[0])
        self.first_token = int(first_token)
        self.shared_pages = tuple(int(p) for p in shared_pages)
        self.straddle_page = None if straddle_page is None \
            else int(straddle_page)
        self.params_token = int(params_token)
        self.pinned = 0         # pins outstanding (probe'd, not released)

    def pages(self) -> List[int]:
        """Every physical page this entry holds a reference on."""
        out = [p for p in self.shared_pages if p != GARBAGE_PAGE]
        if self.straddle_page is not None \
                and self.straddle_page != GARBAGE_PAGE:
            out.append(self.straddle_page)
        return out


class PrefixStore:
    """Bounded LRU of prefix entries over one :class:`PagePool`.

    The store holds its OWN reference on every entry's pages (donor
    slots free theirs at completion; the bytes stay resident for future
    sharers until LRU eviction). ``probe`` returns a PINNED entry —
    page references already incremented for the caller — so the
    admission-to-join window is safe against concurrent eviction; the
    caller MUST pair every probe hit with ``consume`` (the join) or
    ``release`` (the request shed before reaching a slot)."""

    def __init__(self, pool: PagePool, capacity: int):
        self.pool = pool
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("serve.prefix")
        self._entries: "collections.OrderedDict[Tuple[int, bytes], PrefixEntry]" \
            = collections.OrderedDict()
        self._params_token: Optional[int] = None
        self._c_hits = counter("serve.prefix.hits")
        self._c_misses = counter("serve.prefix.misses")
        self._c_shared = counter("serve.prefix.shared_pages")
        self._c_skipped = counter("serve.prefix.prefill_skipped")
        self._g_entries = gauge("serve.prefix.entries")

    # -- read path -----------------------------------------------------------
    def probe(self, tokens: np.ndarray, bucket: int,
              params_token: int) -> Optional[PrefixEntry]:
        """Admission-time probe: a pinned entry for this exact prompt at
        this bucket under the CURRENT weights, or None. A params-token
        mismatch invalidates every entry (hot-swap discipline)."""
        key = prompt_key(tokens, bucket)
        tok = np.asarray(tokens, np.int32)
        evicted: List[PrefixEntry] = []
        with self._lock:
            self._check_params_locked(params_token, evicted)
            entry = self._entries.get(key)
            if entry is not None and (
                    entry.length != tok.shape[0]
                    or not np.array_equal(entry.tokens, tok)):
                entry = None                 # hash collision: exact loses
            if entry is not None:
                self._entries.move_to_end(key)
                entry.pinned += 1
                self.pool.incref(entry.pages())
        self._drop(evicted)
        if entry is None:
            self._c_misses.inc()
        else:
            self._c_hits.inc()
        return entry

    def consume(self, entry: PrefixEntry) -> None:
        """A pinned probe result reached its slot: the slot now owns the
        pinned page references (it decrefs them at completion like any
        other pages it holds). Counts the skipped prefill."""
        with self._lock:
            entry.pinned -= 1
        self._c_skipped.inc()
        self._c_shared.inc(len(entry.pages()))

    def release(self, entry: PrefixEntry) -> None:
        """A pinned probe result never reached a slot (shed / cancelled
        / expired): give the page references back."""
        with self._lock:
            entry.pinned -= 1
        self.pool.decref(entry.pages())

    # -- write path ----------------------------------------------------------
    def publish(self, tokens: np.ndarray, bucket: int, first_token: int,
                shared_pages, straddle_page: Optional[int],
                params_token: int) -> None:
        """Record a fresh prefill's output. The store takes its own page
        references (incref) so donor-slot completion cannot free the
        bytes. Publishing an already-present key refreshes LRU order
        only (the resident bytes are identical by construction)."""
        key = prompt_key(tokens, bucket)
        evicted: List[PrefixEntry] = []
        with self._lock:
            self._check_params_locked(params_token, evicted)
            if key in self._entries:
                self._entries.move_to_end(key)
                self._g_entries.set(len(self._entries))
            else:
                entry = PrefixEntry(tokens, bucket, first_token,
                                    shared_pages, straddle_page,
                                    params_token)
                self.pool.incref(entry.pages())
                self._entries[key] = entry
                n_over = len(self._entries) - self.capacity
                for _ in range(n_over):
                    _, old = self._entries.popitem(last=False)
                    evicted.append(old)
                self._g_entries.set(len(self._entries))
        self._drop(evicted, evicting=True)

    def reclaim(self, target_pages: int) -> int:
        """Evict LRU entries until ``target_pages`` pages actually
        returned to the pool (or the store is empty). The allocation
        path calls this when the pool runs dry: cache RETENTION must
        yield to live admissions, otherwise retained pages could starve
        the pool permanently — no slot completes, no publish happens,
        and LRU eviction (which only runs on publish) never fires.
        Returns the pages freed; entries whose pages are still pinned
        or slot-shared release only the store's reference."""
        freed = 0
        while freed < target_pages:
            with self._lock:
                if not self._entries:
                    break
                _, old = self._entries.popitem(last=False)
                self._g_entries.set(len(self._entries))
            freed += self.pool.decref(old.pages(), evicting=True)
        return freed

    def invalidate(self) -> None:
        """Drop every entry (checkpoint swap hook — also triggered
        lazily by a params-token mismatch on the next probe/publish)."""
        with self._lock:
            evicted = list(self._entries.values())
            self._entries.clear()
            self._g_entries.set(0)
        self._drop(evicted, evicting=True)

    def _check_params_locked(self, params_token: int,
                             evicted: List[PrefixEntry]) -> None:
        if self._params_token != params_token:
            evicted.extend(self._entries.values())
            self._entries.clear()
            self._g_entries.set(0)
            self._params_token = params_token

    def _drop(self, entries: List[PrefixEntry],
              evicting: bool = False) -> None:
        # Outside the store lock: decref takes the pool lock, and the
        # admission fast path must never wait on an eviction sweep.
        for e in entries:
            self.pool.decref(e.pages(), evicting=evicting)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
