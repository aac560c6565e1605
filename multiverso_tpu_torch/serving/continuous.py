"""Iteration-level continuous batching for attention-LM decode.

Port of ``multiverso_tpu/serving/continuous.py``. The drain-first path
(:class:`~multiverso_tpu_torch.serving.runners.AttentionLMRunner` behind
the plain :class:`DynamicBatcher`) coalesces prompts into a batch, then
runs prefill + the FULL ``max_new``-step decode as one dispatch: a request
arriving one step after a batch launched waits out the whole bucket.

This module decodes step by step from the host instead: ``prefill`` (one
prompt into one KV-cache slot) and ``step`` (one cached-attention token
step for ALL slots at once, with a per-slot step counter). New requests
claim free KV-cache slots at step boundaries and ride along with whatever
is mid-decode; a finished slot frees at the next boundary. Every slot's
computation depends only on its own row (its cache rows, its mask
``key_slot < len`` or ``bucket <= key_slot <= bucket + t_slot``, its
position ``len + t_slot``), so a late joiner's tokens are those of
decoding it alone through the drain path.

The host loop queues the steps on the card without waiting; the only
sync is one row read per boundary at which requests complete. Each step
is handed COPIES of the host-side counters (``lengths``, ``t``) and of
the page table: the worker mutates those numpy arrays in place after it
queued the step (``eng.t[i] += 1``), and a step that aliased them could
read the next step's values. (The JAX package hands ``jnp.asarray`` of
the live arrays, which aliases on its CPU backend: ROADMAP C3.)

PAGED mode (``paged=True`` / ``-serve_paged_kv``): every engine draws
fixed-size KV pages from ONE shared :class:`~multiverso_tpu_torch.
serving.paged.PagePool` through per-slot page tables; pool exhaustion
QUEUES the request at admission, and a request that can never fit is
shed. The pages hold ``kv_dtype`` payloads (f32, bf16, or int8 with a
float32 scale a row, ``serving/quant.py``), encoded at prefill and at
every step. On a card the step reads the pool through B7
(``ops/attention.py::paged_decode_attn``), one launch per layer, int8
pages dequantized by their scale planes inside it; on the CPU through its
plain gather formulation.

A :class:`~multiverso_tpu_torch.serving.prefix.PrefixStore`
(``prefix_entries > 0``, paged only) shares prefill work and KV pages
between requests with the same prompt: a claim probes the store and pins
a hit's pages, the join aliases the shared prompt pages, copies the
straddle page on extend (payload and scales, every layer) and skips the
prefill; a fresh prefill publishes its prompt pages and first token when
it is delivered. A dry pool first reclaims the store's retention, and a
weights swap (the runner's monotonic version) invalidates it.

Telemetry: ``serve.continuous.active`` gauge (occupied slots),
``serve.continuous.joins`` / ``serve.continuous.steps`` /
``serve.continuous.batched_reads`` counters, ``serve.kv.*`` (pool),
``serve.prefix.*`` (sharing), and the first-token / per-token latency
histograms read from the device clock.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multiverso_tpu_torch.serving.batcher import (DynamicBatcher,
                                                  ServeRequest, ShedError)
from multiverso_tpu_torch.serving.device_clock import DeviceClock
from multiverso_tpu_torch.serving.paged import (GARBAGE_PAGE, PagePlan,
                                                PagePool, default_pool_pages,
                                                page_plan, pages_of)
from multiverso_tpu_torch.serving.prefix import PrefixEntry, PrefixStore
from multiverso_tpu_torch.serving.quant import storage_dtype
from multiverso_tpu_torch.serving.runners import (attn_scale, cache_read,
                                                  decode_step, key_mask,
                                                  paged_read, paged_write,
                                                  prefill,
                                                  write_prompt_pages)
from multiverso_tpu_torch.telemetry import child_of, counter, emit_span, gauge
from multiverso_tpu_torch.utils.log import check, log


class _SlotEngine:
    """Per-bucket decode state: B cache slots sharing one KV cache of
    shape ``[layers, B, heads, bucket+max_new, dh]`` plus the device-side
    carry (current token per slot, token output buffer) and the host-side
    slot table (which request owns which slot, its prompt length and
    step counter)."""

    __slots__ = ("bucket", "ck", "cv", "out", "tok", "lengths", "t",
                 "reqs", "t_join", "first_mark", "last_mark")

    def __init__(self, bucket: int, max_batch: int, max_new: int,
                 cache_shape, device):
        self.bucket = bucket
        self.ck = self.cv = None
        if cache_shape is not None:
            self.ck = torch.zeros(cache_shape, device=device)
            self.cv = torch.zeros(cache_shape, device=device)
        self.out = torch.zeros((max_batch, max_new), dtype=torch.int32,
                               device=device)
        self.tok = torch.zeros((max_batch,), dtype=torch.int32,
                               device=device)
        self.lengths = np.ones(max_batch, dtype=np.int32)
        self.t = np.zeros(max_batch, dtype=np.int32)
        self.reqs: List[Optional[ServeRequest]] = [None] * max_batch
        self.t_join = [0.0] * max_batch
        # Device-clock marks: each slot's first token (after its
        # prefill) and the engine's latest step.
        self.first_mark: List[object] = [None] * max_batch
        self.last_mark: object = None

    def free_slot(self) -> int:
        for i, r in enumerate(self.reqs):
            if r is None:
                return i
        return -1

    def n_active(self) -> int:
        return sum(1 for r in self.reqs if r is not None)

    def counters(self, device):
        """COPIES of the host counters on ``device``: the worker mutates
        ``lengths``/``t`` in place after queueing the step."""
        return (torch.tensor(self.lengths.copy(), device=device),
                torch.tensor(self.t.copy(), device=device))


class _PagedEngine(_SlotEngine):
    """Per-bucket decode state, paged flavor: no cache of its own; a
    per-slot PAGE TABLE (host int32 + a device copy refreshed when dirty)
    maps this engine's logical cache positions into the shared pool.
    ``slot_pages[s]`` is every physical page slot ``s`` holds a reference
    on (freed at delivery); idle slots' rows point at the garbage page so
    their confined-garbage step writes land nowhere. ``pending_publish[s]``
    is the prefix store's record of a fresh prefill (payload, shared
    pages, straddle page, weights token), published at delivery, when the
    first token is on the host anyway."""

    __slots__ = ("n_logical", "ptab", "ptab_dev", "ptab_dirty",
                 "slot_pages", "pending_publish")

    def __init__(self, bucket: int, max_batch: int, max_new: int,
                 page: int, device):
        super().__init__(bucket, max_batch, max_new, None, device)
        self.n_logical = pages_of(bucket + max_new, page)
        self.ptab = np.zeros((max_batch, self.n_logical), dtype=np.int32)
        self.ptab_dev = None
        self.ptab_dirty = True
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.pending_publish: List[Optional[tuple]] = [None] * max_batch

    def device_ptab(self, device) -> torch.Tensor:
        """The page table on ``device``: a copy, remade when dirty."""
        if self.ptab_dirty or self.ptab_dev is None:
            self.ptab_dev = torch.tensor(self.ptab.copy(), device=device)
            self.ptab_dirty = False
        return self.ptab_dev


class _PagedClaim:
    """Pages and the prefix pin reserved for one queued request at claim
    time (under the batcher cv). Released on every shed path, consumed by
    the join."""

    __slots__ = ("plan", "entry", "pages")

    def __init__(self, plan: PagePlan, entry: Optional[PrefixEntry],
                 pages: List[int]):
        self.plan = plan
        self.entry = entry
        self.pages = pages


class ContinuousBatcher(DynamicBatcher):
    """Drop-in batcher for :class:`AttentionLMRunner` decode with
    iteration-level admission.

    Reuses the :class:`DynamicBatcher` surface whole (deadline-aware
    admission, cancel tokens, quiesce barrier, close semantics) and
    replaces the worker loop: it claims free KV-cache slots for queued
    requests, prefills them, and advances every engine one decode step
    per iteration. ``max_wait_ms`` is pinned to 0.

    Paged-mode knobs: ``paged`` switches the engines onto the shared page
    pool; ``kv_dtype`` ('f32'|'bf16'|'int8') the page storage codec;
    ``page`` the page size in token positions; ``pool_pages`` the pool
    capacity (None = auto: full backing for every bucket engine; set LOWER
    to enforce a memory budget, exhaustion queues); ``prefix_entries``
    the prefix store's capacity (0 = off; needs ``paged``). The engines
    live on the runner's device."""

    def __init__(self, runner, buckets: Sequence[int],
                 max_batch: int = 8, max_queue: int = 64,
                 paged: bool = False, kv_dtype: str = "f32",
                 page: int = 16, pool_pages: Optional[int] = None,
                 prefix_entries: int = 0):
        cfg = runner.cfg
        check(cfg.moe_experts == 0 and cfg.pipeline_stages == 0,
              "continuous decode supports the flat dense attention_lm "
              "layout")
        self.runner_ref = runner
        self.cfg = cfg
        self.max_new = int(runner.max_new)
        self.paged = bool(paged)
        self.kv_dtype = storage_dtype(kv_dtype)
        self.page = int(page)
        check(self.page >= 1, "page size must be >= 1")
        check(self.kv_dtype == "f32" or self.paged,
              "quantized KV storage (-serve_kv_dtype) requires the paged "
              "cache (-serve_paged_kv)")
        check(prefix_entries == 0 or self.paged,
              "the prefix cache shares KV pages and requires the paged "
              "cache (-serve_paged_kv)")
        self.device = runner.device
        self.clock = DeviceClock(self.device)
        # Engines + slot accounting exist BEFORE super().__init__ starts
        # the worker thread (which immediately enters our _loop).
        self._engines: Dict[int, _SlotEngine] = {}
        self._active: "collections.Counter" = collections.Counter()
        self._g_active = gauge("serve.continuous.active")
        self._c_joins = counter("serve.continuous.joins")
        self._c_steps = counter("serve.continuous.steps")
        self._c_batched_reads = counter("serve.continuous.batched_reads")
        self._c_pool_exhausted = counter("serve.kv.pool_exhausted")
        self._c_cow = counter("serve.prefix.copy_on_extend")
        self.pool: Optional[PagePool] = None
        self.prefix: Optional[PrefixStore] = None
        if self.paged:
            n_pages = int(pool_pages) if pool_pages else \
                default_pool_pages(buckets, max_batch, self.max_new,
                                   self.page)
            self.pool = PagePool(n_pages, cfg.layers, cfg.heads,
                                 self.page, cfg.dim // cfg.heads,
                                 self.kv_dtype, device=self.device)
            if prefix_entries > 0:
                self.prefix = PrefixStore(self.pool, prefix_entries)
        super().__init__(runner, buckets, max_batch=max_batch,
                         max_wait_ms=0.0, max_queue=max_queue,
                         pipeline_depth=0)

    # -- step functions ------------------------------------------------------
    # The math is the drain path's (runners.py) per row: one prompt per
    # prefill, a per-slot step counter vector in step. Each updates the
    # cache, pool and token tensors in place and returns them (the JAX
    # package donates and returns them).
    def _prefill_fn(self, params, tokens, length, slot, ck, cv, out, tok):
        """tokens [1, S] right-padded, length [1], slot int -> writes the
        prompt's K/V into cache row ``slot``, the first greedy token into
        ``out[slot, 0]`` and ``tok[slot]``."""
        S = tokens.shape[1]

        def write(i, k, v):
            ck[i, slot, :, :S] = k[0]
            cv[i, slot, :, :S] = v[0]

        first = prefill(params, self.cfg, tokens, length.clamp(min=1),
                        self.runner_ref.posenc(S), write)
        out[slot, 0] = first[0]
        tok[slot] = first[0]
        return ck, cv, out, tok

    def _step_fn(self, params, lengths, t, ck, cv, out, tok):
        """One cached-attention step for EVERY slot at once; ``t`` is the
        per-slot step counter (generated token ``t`` is on deck: its K/V
        lands in cache slot ``S+t_row``, its position is ``len_row +
        t_row``, and the emitted token writes ``out[row, t_row+1]``).
        Idle slots compute garbage confined to their own rows."""
        N = self.max_new
        S = ck.shape[3] - N
        B = tok.shape[0]
        scale = attn_scale(self.cfg.dim // self.cfg.heads)
        rows = torch.arange(B, device=tok.device)
        heads = torch.arange(self.cfg.heads, device=tok.device)
        idx = (rows[:, None], heads[None, :], (S + t).long()[:, None])
        mask = key_mask(S + N, S, lengths, t)

        def attend(i, q, k, v):
            ck[i][idx] = k
            cv[i][idx] = v
            return cache_read(q, ck[i], cv[i], mask, scale)

        nxt = decode_step(params, self.cfg, tok, lengths + t,
                          self.runner_ref.posenc(S), attend)
        out[rows, (t + 1).clamp(0, N - 1).long()] = nxt
        return ck, cv, out, nxt

    def _prefill_paged_fn(self, bucket, params, tokens, length, slot,
                          pages, kp, vp, ks, vs, out, tok):
        """One prompt into its pages: ``pages`` [ceil(bucket/page)] are
        the slot's physical ids for the prompt-region logical pages
        (garbage page 0 for unbacked pad pages, whose writes are never
        attended). K and V are encoded in ``kv_dtype``; int8 writes each
        row's scale into ``ks``/``vs``."""
        pages = pages.long()
        pool = (kp, vp, ks, vs)

        def write(i, k, v):
            write_prompt_pages(pool, i, pages, k, v, self.page,
                               self.kv_dtype)

        first = prefill(params, self.cfg, tokens, length.clamp(min=1),
                        self.runner_ref.posenc(bucket), write)
        out[slot, 0] = first[0]
        tok[slot] = first[0]
        return kp, vp, ks, vs, out, tok

    def _step_paged_fn(self, bucket, params, lengths, t, ptab, kp, vp,
                       ks, vs, out, tok):
        """The per-slot-counter step over paged storage: encode the new
        token's K/V and store it in each slot's CURRENT generated page
        (idle slots' tables point at the garbage page), then read the
        slot's pages through ``paged_decode_attn`` (B7 on a card, with
        the scale planes for int8)."""
        S, N, P = bucket, self.max_new, self.page
        B = tok.shape[0]
        scale = attn_scale(self.cfg.dim // self.cfg.heads)
        rows = torch.arange(B, device=tok.device)
        gphys = ptab.gather(1, ((S + t) // P).long()[:, None])[:, 0]
        goff = (S + t) % P
        pool = (kp, vp, ks, vs)

        def attend(i, q, k, v):
            paged_write(pool, i, gphys, goff, k, v, self.kv_dtype)
            return paged_read(pool, i, q, ptab, lengths, t, bucket=S,
                              page=P, scale=scale)

        nxt = decode_step(params, self.cfg, tok, lengths + t,
                          self.runner_ref.posenc(S), attend)
        out[rows, (t + 1).clamp(0, N - 1).long()] = nxt
        return kp, vp, ks, vs, out, nxt

    @staticmethod
    def _copy_page_fn(src: int, dst: int, kp, vp, ks, vs):
        """Copy-on-extend: clone physical page ``src`` into ``dst`` (a
        prefix sharer's straddle page), payload and scale planes of every
        layer, in place, in stream order after every launch queued
        before it."""
        for t in (kp, vp, ks, vs):
            t[dst].copy_(t[src])
        return kp, vp, ks, vs

    # -- engine management ---------------------------------------------------
    def _engine_for(self, bucket: int) -> _SlotEngine:
        eng = self._engines.get(bucket)
        if eng is None:
            if self.paged:
                eng = _PagedEngine(bucket, self.max_batch, self.max_new,
                                   self.page, self.device)
            else:
                eng = _SlotEngine(
                    bucket, self.max_batch, self.max_new,
                    self.runner_ref.cache_shape(bucket, self.max_batch),
                    self.device)
            self._engines[bucket] = eng
        return eng

    def _step_once(self, eng: _SlotEngine, params) -> None:
        """Queue one step of ``eng`` with copies of its counters."""
        lengths, t = eng.counters(self.device)
        if self.paged:
            kp, vp, ks, vs = self.pool.arrays()
            _, _, _, _, eng.out, eng.tok = self._step_paged_fn(
                eng.bucket, params, lengths, t,
                eng.device_ptab(self.device), kp, vp, ks, vs, eng.out,
                eng.tok)
        else:
            eng.ck, eng.cv, eng.out, eng.tok = self._step_fn(
                params, lengths, t, eng.ck, eng.cv, eng.out, eng.tok)

    def warmup(self) -> int:
        """Run prefill + step once for every ladder bucket (the service
        warmup hook: the first real request pays no first-launch costs,
        such as loading B7's library). Paged warmup writes the garbage
        page only (no allocation)."""
        params = self.runner_ref.params_ref()
        one = torch.ones((1,), dtype=torch.int32, device=self.device)
        warmed = 0
        for bucket in self.ladder.buckets:
            eng = self._engine_for(bucket)
            zeros = torch.zeros((1, bucket), dtype=torch.int32,
                                device=self.device)
            if self.paged:
                pages0 = torch.zeros((pages_of(bucket, self.page),),
                                     dtype=torch.int32, device=self.device)
                kp, vp, ks, vs = self.pool.arrays()
                self._prefill_paged_fn(bucket, params, zeros, one, 0,
                                       pages0, kp, vp, ks, vs, eng.out,
                                       eng.tok)
            else:
                self._prefill_fn(params, zeros, one, 0, eng.ck, eng.cv,
                                 eng.out, eng.tok)
            self._step_once(eng, params)
            warmed += 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    # -- the iteration loop --------------------------------------------------
    def _loop(self) -> None:  # overrides DynamicBatcher._loop
        from multiverso_tpu_torch.telemetry import watchdog_scope
        with watchdog_scope("serve-continuous", timeout_s=60.0) as wd:
            self._wd = wd
            self._run_decode_loop(wd)

    def _run_decode_loop(self, wd) -> None:
        while True:
            wd.beat()
            with self._cv:
                while self._running and not self._queue \
                        and not self._n_active_locked():
                    self._cv.wait(0.05)
                    wd.beat()       # idle is progress, not a wedge
                if not self._running and not self._queue \
                        and not self._n_active_locked():
                    return
                claims = self._claim_locked()
                if claims or self._n_active_locked():
                    self._busy = True
                elif self._queue:
                    # Pool-stalled: queued work, nothing claimable,
                    # nothing decoding. Wait for a submit/cancel/close
                    # instead of spinning the claim loop hot (page frees
                    # happen on THIS thread, so nothing is missed).
                    self._cv.wait(0.05)
                self._g_depth.set(len(self._queue))
            self._admit_claims(claims)
            # Deliver BEFORE stepping: a slot that completed on the
            # previous step, or straight out of prefill when max_new==1,
            # must hand its tokens over before another step can write
            # into its out row.
            self._deliver_finished()
            self._step_engines()
            self._deliver_finished()
            with self._cv:
                if not self._n_active_locked() and not self._queue:
                    self._busy = False

    def _n_active_locked(self) -> int:
        return sum(self._active.values())

    def _claim_locked(self) -> List[ServeRequest]:
        """FIFO claim of queued requests into free slots, per bucket: the
        step-boundary admission. Requests whose bucket is full stay
        queued in order. Paged mode ALSO reserves the request's physical
        pages here (under the cv): a request the pool cannot serve stays
        queued, and blocks later claims for this round so that a stream
        of small requests cannot starve a large one, until delivery
        frees pages at a step boundary."""
        claims: List[ServeRequest] = []
        remaining: List[ServeRequest] = []
        claimed: "collections.Counter" = collections.Counter()
        pool_blocked = False
        for req in self._queue:
            b = self.ladder.pick(req.payload.shape[0])
            if self._active[b] + claimed[b] >= self.max_batch:
                remaining.append(req)
                continue
            if self.paged \
                    and getattr(req, "_paged_claim", None) is None:
                plan = page_plan(req.payload.shape[0], b, self.max_new,
                                 self.page)
                if plan.n_backed > self.pool.capacity:
                    # Never fits: no amount of freeing serves this
                    # request; shed it NOW (outside the cv, via the
                    # claims list) instead of queueing it forever.
                    req._paged_doomed = True
                    claims.append(req)
                    continue
                if pool_blocked or not self._reserve_paged(req, b, plan):
                    if not pool_blocked:
                        pool_blocked = True
                        self._c_pool_exhausted.inc()
                    remaining.append(req)
                    continue
            claimed[b] += 1
            claims.append(req)
        self._queue.clear()
        self._queue.extend(remaining)
        for b, n in claimed.items():
            self._active[b] += n
        return claims

    def _params_token(self) -> int:
        """The prefix store's weights token: the runner's MONOTONIC swap
        version (object identity would be unsound: a freed dict's address
        can come back after two swaps)."""
        fn = getattr(self.runner_ref, "params_versioned", None)
        if fn is None:          # foreign runner: identity is best-effort
            return id(self.runner_ref.params_ref())
        return int(fn()[1])

    def _reserve_paged(self, req: ServeRequest, bucket: int,
                       plan: PagePlan) -> bool:
        """Pin the prefix entry (when the store knows this prompt) and
        allocate the pages the slot will own. A dry pool first RECLAIMS
        the store's retention (cache bytes yield to live admissions:
        retained pages could otherwise starve the pool, since the store
        evicts only on publish and a publish needs a completed request).
        False = the pool is exhausted; the request keeps its queue
        position."""
        entry = None
        if self.prefix is not None:
            entry = self.prefix.probe(req.payload, bucket,
                                      self._params_token())
        need = len(plan.private) if entry is not None \
            else len(plan.shared) + len(plan.private)
        pages = self.pool.alloc(need)
        if pages is None and self.prefix is not None:
            if self.prefix.reclaim(need - self.pool.free_pages()) > 0:
                pages = self.pool.alloc(need)
        if pages is None:
            if entry is not None:
                self.prefix.release(entry)
            return False
        req._paged_claim = _PagedClaim(plan, entry, pages)
        return True

    def _release_claim(self, req: ServeRequest) -> None:
        """Give back a reserved claim that will never reach a slot."""
        claim = getattr(req, "_paged_claim", None)
        if claim is None:
            return
        req._paged_claim = None
        if claim.entry is not None:
            self.prefix.release(claim.entry)
        if claim.pages:
            self.pool.decref(claim.pages)

    def _unclaim(self, bucket: int) -> None:
        with self._cv:
            self._active[bucket] -= 1

    def _admit_claims(self, claims: List[ServeRequest]) -> None:
        now = time.monotonic()
        for req in claims:
            if getattr(req, "_paged_doomed", False):
                # Needs more pages than the pool will EVER hold: an
                # admission-time config mismatch, shed with the reason.
                self._c_shed_oversize.inc()
                self._safe_done(req, ShedError(
                    "oversize",
                    "request needs more KV pages than the pool holds "
                    "(raise -serve_kv_pages or shrink the bucket "
                    "ladder)"))
                continue
            bucket = self.ladder.pick(req.payload.shape[0])
            if req.cancelled:
                self._c_cancelled.inc()
                self._unclaim(bucket)
                self._release_claim(req)
                self._safe_done(req, ShedError("cancelled",
                                               "hedged loser cancelled"))
            elif req.deadline < now:
                self._c_shed_deadline.inc()
                self._unclaim(bucket)
                self._release_claim(req)
                self._safe_done(req, ShedError("deadline",
                                               "expired while queued"))
            else:
                self._h_admit.observe((now - req.t_submit) * 1e3)
                if req.ctx is not None and req.ctx.sampled:
                    # Phase ledger: queue = enqueue -> claimed at a step
                    # boundary (the continuous analog of batch gather).
                    t_enq = req.t_enqueue or req.t_submit
                    emit_span("serve.admit_wait", child_of(req.ctx),
                              t_enq, (now - t_enq) * 1e3)
                self._join(req, bucket)

    def _join(self, req: ServeRequest, bucket: int) -> None:
        """Prefill one prompt into a free KV-cache slot. The join is a
        device launch like any step, so it lands exactly at a step
        boundary of everything already decoding in this engine. Paged
        joins wire the slot's page table first; a prefix hit skips the
        prefill (the shared pages hold the prompt's K/V and the entry the
        first greedy token)."""
        eng = self._engine_for(bucket)
        slot = eng.free_slot()
        try:
            check(slot >= 0, "claim accounting out of slots")
            n = req.payload.shape[0]
            tokens = np.zeros((1, bucket), dtype=np.int32)
            tokens[0, :n] = req.payload
            tokens = torch.tensor(tokens, device=self.device)
            length = torch.tensor([max(n, 1)], dtype=torch.int32,
                                  device=self.device)
            if self.paged:
                self._join_paged(req, eng, slot, bucket, tokens, length)
            else:
                params = self.runner_ref.params_ref()
                eng.ck, eng.cv, eng.out, eng.tok = self._prefill_fn(
                    params, tokens, length, slot, eng.ck, eng.cv, eng.out,
                    eng.tok)
        except Exception as e:  # noqa: BLE001 - a poisoned prompt sheds
            log.error("continuous decode: prefill failed: %s", e)  # alone
            self._unclaim(bucket)
            self._release_claim(req)
            self._safe_done(req, ShedError("closed", f"runner error: {e}"))
            return
        eng.first_mark[slot] = self.clock.mark()
        eng.reqs[slot] = req
        eng.lengths[slot] = max(n, 1)
        eng.t[slot] = 0
        eng.t_join[slot] = time.monotonic()
        self._c_joins.inc()
        self._c_requests.inc()
        self._g_active.set(self._total_active())
        self._g_inflight.set(self._total_active())

    def _join_paged(self, req: ServeRequest, eng: _PagedEngine, slot: int,
                    bucket: int, tokens, length) -> None:
        claim: Optional[_PagedClaim] = getattr(req, "_paged_claim", None)
        check(claim is not None, "paged join without a page claim")
        # The claim stays ON the request until the slot owns everything:
        # a failure below propagates to _join's handler, whose
        # _release_claim gives the pinned entry and the pages back exactly
        # once. Only the last line hands them to the slot.
        plan, entry, pages = claim.plan, claim.entry, claim.pages
        row = np.zeros(eng.n_logical, dtype=np.int32)
        versioned = getattr(self.runner_ref, "params_versioned", None)
        if versioned is not None:
            params, params_token = versioned()
        else:
            params = self.runner_ref.params_ref()
            params_token = id(params)
        kp, vp, ks, vs = self.pool.arrays()
        if entry is not None:
            # Prefix hit: alias the shared prompt pages, own the private
            # generated pages; the straddle page (prompt tail + generated
            # head) copies on extend when it holds real prompt tokens.
            for logical, phys in zip(plan.shared, entry.shared_pages):
                row[logical] = phys
            for logical, phys in zip(plan.private, pages):
                row[logical] = phys
            if plan.straddle_has_prompt:
                check(entry.straddle_page is not None,
                      "prefix entry lost its straddle page")
                dst = pages[plan.private.index(plan.straddle)]
                self._copy_page_fn(entry.straddle_page, dst, kp, vp, ks, vs)
                self._c_cow.inc()
            eng.out[slot, 0] = entry.first_token
            eng.tok[slot] = entry.first_token
            eng.slot_pages[slot] = list(entry.pages()) + list(pages)
            self.prefix.consume(entry)
        else:
            shared = pages[:len(plan.shared)]
            private = pages[len(plan.shared):]
            for logical, phys in zip(plan.shared, shared):
                row[logical] = phys
            for logical, phys in zip(plan.private, private):
                row[logical] = phys
            prompt_pages = torch.tensor(row[:plan.n_prompt],
                                        device=self.device)
            _, _, _, _, eng.out, eng.tok = self._prefill_paged_fn(
                bucket, params, tokens, length, slot, prompt_pages, kp, vp,
                ks, vs, eng.out, eng.tok)
            eng.slot_pages[slot] = list(pages)
            if self.prefix is not None:
                straddle_phys = None
                if plan.straddle_has_prompt:
                    straddle_phys = private[plan.private.index(
                        plan.straddle)]
                eng.pending_publish[slot] = (
                    np.array(req.payload, np.int32, copy=True), shared,
                    straddle_phys, params_token)
        eng.ptab[slot] = row
        eng.ptab_dirty = True
        req._paged_claim = None         # the slot owns the pages now

    def _total_active(self) -> int:
        return sum(e.n_active() for e in self._engines.values())

    def _step_engines(self) -> None:
        params = None
        for eng in self._engines.values():
            if eng.n_active() == 0:
                continue
            if params is None:
                params = self.runner_ref.params_ref()
            try:
                self._step_once(eng, params)
            except Exception as e:  # noqa: BLE001 - shed this engine's
                log.error("continuous decode: step failed: %s", e)  # slots
                self._fail_engine(eng, e)
                continue
            eng.last_mark = self.clock.mark()
            self._c_steps.inc()
            for i, r in enumerate(eng.reqs):
                if r is not None:
                    eng.t[i] += 1

    def _publish_pending(self, eng, slot: int, row) -> None:
        """The deferred prefix publish at delivery: the first token is in
        the delivered row on the host, and the store takes its page
        references BEFORE the slot drops its own (below), so an entry
        never holds freed pages."""
        pending = eng.pending_publish[slot]
        eng.pending_publish[slot] = None
        if pending is None or self.prefix is None \
                or not isinstance(row, np.ndarray):
            return
        payload, shared, straddle_phys, params_token = pending
        try:
            self.prefix.publish(payload, eng.bucket, int(row[0]), shared,
                                straddle_phys, params_token)
        except Exception as e:  # noqa: BLE001 - a publish failure loses
            log.error("prefix publish failed: %s", e)  # only reuse

    def _free_slot_pages(self, eng, slot: int) -> None:
        """Return a paged slot's page references and point its table row
        at the garbage page (an idle slot's confined-garbage step writes
        must never land in a page someone else now owns)."""
        if not self.paged:
            return
        eng.pending_publish[slot] = None
        pages = eng.slot_pages[slot]
        eng.slot_pages[slot] = []
        eng.ptab[slot, :] = GARBAGE_PAGE
        eng.ptab_dirty = True
        if pages:
            self.pool.decref(pages)

    def _fail_engine(self, eng, err: Exception) -> None:
        for i, r in enumerate(eng.reqs):
            if r is None:
                continue
            eng.reqs[i] = None
            eng.lengths[i] = 1
            eng.t[i] = 0
            self._free_slot_pages(eng, i)
            self._unclaim(eng.bucket)
            self._safe_done(r, ShedError("closed", f"runner error: {err}"))
        self._g_active.set(self._total_active())
        self._g_inflight.set(self._total_active())

    def _observe_token_times(self, eng, slot: int, r: ServeRequest) -> None:
        first = self.clock.host_time(eng.first_mark[slot])
        self._h_first.observe((first - r.t_submit) * 1e3)
        if self.max_new > 1:
            last = self.clock.host_time(eng.last_mark)
            self._h_per_token.observe((last - first) * 1e3
                                      / (self.max_new - 1))

    def _deliver_finished(self) -> None:
        """Slots with all ``max_new`` tokens emitted deliver and free at
        this step boundary (in paged mode their pages return to the pool
        HERE). Completions that land at the SAME boundary are read back
        as ONE device sync; the per-slot fallback contains a failed
        batched read without losing the error-per-slot semantics."""
        now = time.monotonic()
        for eng in self._engines.values():
            done = [i for i, r in enumerate(eng.reqs)
                    if r is not None and eng.t[i] >= self.max_new - 1]
            if not done:
                continue
            rows = {}
            if len(done) > 1:
                try:
                    idx = torch.tensor(done, device=self.device)
                    block = eng.out.index_select(0, idx).cpu().numpy()
                    rows = {i: block[k] for k, i in enumerate(done)}
                    self._c_batched_reads.inc()
                except Exception as e:  # noqa: BLE001 - fall back per-slot
                    log.error("continuous decode: batched readback "
                              "failed: %s", e)
            for i in done:
                r = eng.reqs[i]
                row = rows.get(i)
                if row is None:
                    try:
                        # A copy: on the CPU ``.cpu().numpy()`` is a view
                        # of ``eng.out``, which the slot's next occupant
                        # overwrites after this request was answered.
                        row = eng.out[i].cpu().numpy().copy()
                    except Exception as e:  # noqa: BLE001 - contain
                        log.error("continuous decode: readback failed: "
                                  "%s", e)
                        row = ShedError("closed", f"runner error: {e}")
                if isinstance(row, np.ndarray):
                    self._observe_token_times(eng, i, r)
                eng.reqs[i] = None
                eng.lengths[i] = 1
                eng.t[i] = 0
                if self.paged:
                    self._publish_pending(eng, i, row)
                self._free_slot_pages(eng, i)
                self._unclaim(eng.bucket)
                if r.ctx is not None and r.ctx.sampled:
                    emit_span("serve.device", child_of(r.ctx),
                              eng.t_join[i], (now - eng.t_join[i]) * 1e3,
                              bucket=eng.bucket, continuous=1)
                self._c_batches.inc()
                self._h_device.observe((now - eng.t_join[i]) * 1e3)
                self._safe_done(r, row)
        self._g_active.set(self._total_active())
        self._g_inflight.set(self._total_active())

    def _safe_done(self, req: ServeRequest, result: object) -> None:
        # Instance override (DynamicBatcher's is a staticmethod): every
        # delivery path funnels here, so a reserved-but-never-joined
        # claim can never leak its pages.
        self._release_claim(req)
        DynamicBatcher._safe_done(req, result)
