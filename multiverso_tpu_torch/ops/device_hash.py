"""Device-resident open-addressing key directory (int64 keys -> slot ids).

Port of ``multiverso_tpu/ops/device_hash.py``. The directory is three
int32 tensors on the table's device (key halves + slot); lookups are a
vectorized linear probe and batch inserts use the standard GPU-hash-table
recipe — rounds of (probe, claim by scatter-min, winners insert) until
every key owns a slot. Duplicate keys within a batch converge because
losers re-probe and find the winner's entry the next round.

The JAX package's directory is jitted XLA (gathers, a scatter-min and
``while_loop``), not a Pallas kernel, so its port is torch ops on the
table's device and no hand-written kernel. It rebuilds the same directory
bit for bit: the same ``k_hi``/``k_lo``/``slot`` arrays and the same slot
ids for the same key batches, so checkpoints and the ``kv_keys`` order of
a payload agree with the JAX package's.

* ``_mix`` is fmix32 in uint32 (logical shifts, wrapping products). Torch
  has almost no uint32 arithmetic, so it runs in int64 masked to 32 bits,
  with each product split so that no int64 product overflows.
* The claim is a deterministic ``scatter_reduce_("amin")`` of batch
  indices into ``C + 1`` buckets, the last one taking every non-pending
  lane (JAX's ``mode="drop"`` at index ``C``): the lowest batch index wins
  each contested bucket, whatever order the device runs in.
* The ``while_loop``s are host loops. An insert round reads one small
  tensor (are keys pending, how many winners); the probe reads whether
  any lane is still probing once every :data:`PROBE_STEPS_PER_READ` steps
  (extra steps of a settled probe change nothing). :data:`ROUNDS` counts
  the insert rounds and probe steps of the last call, for the smoke run's
  report.
* Probing is linear over a power-of-two directory (mask, no division) and
  stops at the first EMPTY bucket — absence proof, and the insert
  position. The directory is at least twice the slot capacity, so the
  load factor stays <= 0.5.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

_EMPTY = -1                     # slot entry for an unoccupied bucket
_M32 = 0xFFFFFFFF
PROBE_STEPS_PER_READ = 4

#: Insert rounds and probe steps of the last ``insert``/``insert_preassigned``
#: and probe steps of the last ``lookup`` (read by the smoke run).
ROUNDS: Dict[str, int] = {"insert_rounds": 0, "probe_steps": 0}


class DirState(NamedTuple):
    """Directory tensors. ``slot[i] < 0`` means bucket i is empty.
    ``next_slot`` (the next unused value-slab row) and ``capacity`` (the
    value-slab rows, <= C // 2) are host ints."""
    k_hi: torch.Tensor          # [C] int32
    k_lo: torch.Tensor          # [C] int32
    slot: torch.Tensor          # [C] int32
    next_slot: int
    capacity: int


def make_state(capacity_slots: int,
               device: torch.device = torch.device("cpu")) -> DirState:
    """Directory sized to the next power of two >= 2x the slot capacity.

    ``capacity_slots`` is remembered so :func:`insert` reports overflow as
    soon as allocations would exceed the value slab the caller sized — not
    only when a probe chain exhausts the (2x larger) directory.
    """
    c = 1
    while c < 2 * max(capacity_slots, 1):
        c *= 2
    return DirState(
        k_hi=torch.zeros(c, dtype=torch.int32, device=device),
        k_lo=torch.zeros(c, dtype=torch.int32, device=device),
        slot=torch.full((c,), _EMPTY, dtype=torch.int32, device=device),
        next_slot=0,
        capacity=int(capacity_slots),
    )


def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 host keys -> (hi, lo) int32 halves."""
    keys = np.asarray(keys, dtype=np.int64)
    return ((keys >> 32).astype(np.int32),
            (keys & 0xFFFFFFFF).astype(np.int32))


def join_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 halves -> int64 keys (the inverse of split_keys)."""
    return ((np.asarray(hi).astype(np.int64) << 32)
            | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2^32`` for int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``b``, with no int64 product above 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """fmix32-style avalanche over both halves, as uint32 values held in
    int64 (the JAX package's ``_mix``, bit for bit)."""
    uhi = hi.to(torch.int64) & _M32
    ulo = lo.to(torch.int64) & _M32
    x = ulo ^ _mul32(uhi, 0x9E3779B9)           # golden-ratio spread
    x = _mul32(x ^ (x >> 16), 0x45D9F3B)
    x = _mul32(x ^ (x >> 16), 0x45D9F3B)
    return x ^ (x >> 16)


def _halves(state: DirState, hi, lo) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = state.slot.device
    return (torch.as_tensor(np.asarray(hi, dtype=np.int32)
                            if not torch.is_tensor(hi) else hi,
                            device=dev).to(torch.int32),
            torch.as_tensor(np.asarray(lo, dtype=np.int32)
                            if not torch.is_tensor(lo) else lo,
                            device=dev).to(torch.int32))


def _probe(state: DirState, hi: torch.Tensor, lo: torch.Tensor):
    """Probe every key until match or first empty bucket.
    Returns (slots [B] (-1 miss), empty_pos [B] (claimable bucket),
    overflow (probe chain exhausted the table — full), probe steps)."""
    C = state.slot.shape[0]
    mask = C - 1
    B = hi.shape[0]
    idx = _mix(hi, lo) & mask
    res = torch.full((B,), -1, dtype=torch.int32, device=hi.device)
    active = torch.ones(B, dtype=torch.bool, device=hi.device)
    steps = 0
    while steps < C:
        if steps % PROBE_STEPS_PER_READ == 0 and not bool(active.any()):
            break
        cur_slot = state.slot[idx]
        is_empty = cur_slot < 0
        is_match = ((~is_empty) & (state.k_hi[idx] == hi)
                    & (state.k_lo[idx] == lo))
        res = torch.where(active & is_match, cur_slot, res)
        active = active & ~(is_match | is_empty)
        idx = torch.where(active, (idx + 1) & mask, idx)
        steps += 1
    # idx now parks at the stopping bucket: the match position or the
    # first empty (claimable) one. `active` still set => table full.
    return res, idx, active.any(), steps


def lookup(state: DirState, hi, lo) -> torch.Tensor:
    """Vectorized probe: returns slots [B] int32 (-1 for absent keys)."""
    hi, lo = _halves(state, hi, lo)
    slots, _, _, steps = _probe(state, hi, lo)
    ROUNDS["probe_steps"] = steps
    return slots


def _claim(C: int, B: int, pending: torch.Tensor, empty_pos: torch.Tensor,
           batch_idx: torch.Tensor) -> torch.Tensor:
    """Lowest batch index wins each contested empty bucket: a scatter-min
    into C + 1 buckets (non-pending lanes go to the last, dropped one)."""
    claim = torch.full((C + 1,), B, dtype=torch.int64,
                       device=empty_pos.device)
    target = torch.where(pending, empty_pos, torch.full_like(empty_pos, C))
    claim.scatter_reduce_(0, target, batch_idx, reduce="amin",
                          include_self=True)
    return pending & (claim[:C][empty_pos] == batch_idx)


def insert(state: DirState, hi, lo
           ) -> Tuple[DirState, torch.Tensor, bool]:
    """Resolve every key to a slot, allocating for unseen keys.

    Returns (new_state, slots [B] int32, overflow). Rounds of: probe ->
    pending keys claim their empty bucket by scatter-min of batch index ->
    winners write (key, fresh slot ids in batch order). Each round settles
    at least one contender per bucket (and duplicate keys find the
    winner's entry on re-probe), so the loop ends in <= B rounds; typical
    is 1-2. The directory tensors are updated in place.
    """
    hi, lo = _halves(state, hi, lo)
    B = hi.shape[0]
    C = state.slot.shape[0]
    dev = hi.device
    batch_idx = torch.arange(B, dtype=torch.int64, device=dev)
    slots = torch.full((B,), -1, dtype=torch.int32, device=dev)
    next_slot, overflow, rounds, steps = state.next_slot, False, 0, 0
    while not overflow and rounds <= B:
        if not bool((slots < 0).any()):
            break
        res, empty_pos, full, n_steps = _probe(state, hi, lo)
        steps += n_steps
        slots = torch.where(slots < 0, res, slots)
        pending = slots < 0
        winner = _claim(C, B, pending, empty_pos, batch_idx)
        new_ids = (next_slot + torch.cumsum(winner.to(torch.int32), 0,
                                            dtype=torch.int32) - 1)
        # One read a round: the winners' count and whether a probe chain
        # exhausted the directory.
        n_new, full = (int(v) for v in torch.stack(
            [winner.sum(), full.to(torch.int64)]).tolist())
        # Slab overflow: allocations this round would exceed the value-slab
        # capacity. The whole round's writes are gated so no out-of-bounds
        # slot id lands in the directory; pending keys come back as -1.
        slab_full = next_slot + n_new > state.capacity
        if not slab_full:
            wpos = empty_pos[winner]
            state.k_hi[wpos] = hi[winner]
            state.k_lo[wpos] = lo[winner]
            state.slot[wpos] = new_ids[winner]
            slots = torch.where(winner, new_ids, slots)
            next_slot += n_new
        overflow = overflow or bool(full) or slab_full
        rounds += 1
    ROUNDS.update(insert_rounds=rounds, probe_steps=steps)
    overflow = overflow or bool((slots < 0).any())
    return state._replace(next_slot=next_slot), slots, overflow


def insert_preassigned(state: DirState, hi, lo, slot_ids
                       ) -> Tuple[DirState, bool]:
    """Place (key, slot_id) pairs into the directory without allocating.

    Checkpoint-restore path: :func:`insert`'s allocation order under bucket
    contention is round-dependent, so re-inserting saved keys does not
    reproduce a saved key->slot mapping. This writes the *saved* slot ids
    verbatim. Returns (new_state, overflow). Keys must be distinct, and a
    key already present with a different slot id is reported as overflow
    (entries are never rewritten) — restore into a fresh directory.
    """
    hi, lo = _halves(state, hi, lo)
    B = hi.shape[0]
    C = state.slot.shape[0]
    dev = hi.device
    slot_ids = torch.as_tensor(np.asarray(slot_ids, dtype=np.int32)
                               if not torch.is_tensor(slot_ids)
                               else slot_ids, device=dev).to(torch.int32)
    batch_idx = torch.arange(B, dtype=torch.int64, device=dev)
    placed = torch.zeros(B, dtype=torch.bool, device=dev)
    next_slot = state.next_slot
    overflow = bool((slot_ids >= state.capacity).any()) if B else False
    rounds = steps = 0
    while not overflow and rounds <= B:
        if not bool((~placed).any()):
            break
        res, empty_pos, full, n_steps = _probe(state, hi, lo)
        steps += n_steps
        # A key already present with a DIFFERENT slot id cannot be honored
        # (linear-probe entries are never rewritten) — report it as
        # overflow rather than silently keeping the stale mapping.
        conflict = (res >= 0) & (res != slot_ids)
        placed = placed | (res >= 0)
        pending = ~placed
        winner = _claim(C, B, pending, empty_pos, batch_idx)
        wpos = empty_pos[winner]
        state.k_hi[wpos] = hi[winner]
        state.k_lo[wpos] = lo[winner]
        state.slot[wpos] = slot_ids[winner]
        top = torch.where(winner, slot_ids + 1,
                          torch.zeros_like(slot_ids)).max()
        conflict_any, full, top = (int(v) for v in torch.stack(
            [conflict.any().to(torch.int64), full.to(torch.int64),
             top.to(torch.int64)]).tolist())
        next_slot = max(next_slot, top)
        placed = placed | winner
        overflow = bool(conflict_any) or bool(full)
        rounds += 1
    ROUNDS.update(insert_rounds=rounds, probe_steps=steps)
    overflow = overflow or bool((~placed).any())
    return state._replace(next_slot=next_slot), overflow
