"""Consistent-hash ring with virtual nodes: row -> replica ownership.

Port of ``multiverso_tpu/fleet/hashring.py``, numpy only: the same sha1
vnode placement and splitmix64 key mix, so the same members own the same
keys in both packages (a router of one package routes for the other's
clients).

The generalization of ``RoutedLookupClient``'s contiguous-offset
arithmetic: instead of ``offsets[s] <= row < offsets[s+1]`` (which moves
O(rows/N) keys whenever the shard count changes), each member owns the
arcs of a hash circle claimed by its virtual nodes. Adding a member to an
N-member ring steals ~1/(N+1) of every incumbent's keys and moves nothing
else; removing a member reassigns ONLY its own keys to the survivors
(Karger et al.'s classic property — the fleet's rolling-drain story
depends on it: a draining replica leaves the ring without invalidating
anyone else's routing).

Hashing is deliberately stable across processes and Python versions:
virtual-node placement uses sha1 (quality matters, runs once per
membership change) and key placement uses a splitmix64 mix (vectorizes
over numpy int arrays for batch routing; runs per request). Never
``hash()`` — PYTHONHASHSEED would desynchronize router and clients.

Construction is a pure function of ``(sorted member ids, vnodes)``, so a
router and its clients independently build IDENTICAL rings from the same
membership list — the routing table only has to ship ids, not arcs.

Vnode **ownership overrides** (the rebalancer's actuation surface,
docs/DESIGN.md "Skew actuation") relax that purity one controlled step:
an override ``(member, vnode, target)`` keeps the vnode's POSITION on
the circle (placed by ``member``'s hash, so nothing else moves) but
hands the arc's keys to ``target``. Overrides ship in the routing
payload next to the member list, so router and clients still build
identical rings — now a pure function of ``(members, vnodes,
overrides)``. An override whose placing member or target has left the
ring is dropped (the arc reverts to its hash owner), which is exactly
the fail-safe a swept member wants.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Tuple

import numpy as np

from multiverso_tpu_torch.utils.log import check

_U64 = np.uint64


def _vnode_position(member: str, vnode: int) -> int:
    digest = hashlib.sha1(f"{member}#{vnode}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def _splitmix64(keys: np.ndarray) -> np.ndarray:
    """Stable 64-bit mix (splitmix64 finalizer), vectorized. Uniform
    enough for ring placement and ~30ns/key over a batch."""
    with np.errstate(over="ignore"):
        z = keys.astype(_U64) + _U64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


class HashRing:
    """Virtual-node consistent-hash ring over string member ids.

    ``vnodes`` trades balance for membership-change cost: 64 vnodes keeps
    the max/mean load ratio near 1.2 for small fleets. The ring is
    immutable-by-rebuild: ``add``/``remove`` recompute the sorted arc
    arrays (membership changes are rare; lookups are the hot path and
    stay two numpy ops)."""

    def __init__(self, members: Iterable[str] = (), vnodes: int = 64,
                 overrides: Iterable[Tuple[str, int, str]] = ()):
        check(vnodes >= 1, "vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._members: List[str] = sorted(set(members))
        self._positions = np.zeros(0, dtype=_U64)
        self._owners = np.zeros(0, dtype=np.int64)
        self._arc_place = np.zeros(0, dtype=np.int64)
        self._arc_vnode = np.zeros(0, dtype=np.int64)
        self._overrides: Dict[Tuple[str, int], str] = {
            (str(m), int(v)): str(t) for m, v, t in overrides}
        self._rebuild()

    # -- membership ---------------------------------------------------------
    @property
    def members(self) -> Tuple[str, ...]:
        return tuple(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def add(self, member: str) -> bool:
        """Add a member; returns False when already present."""
        if member in self._members:
            return False
        self._members = sorted(self._members + [str(member)])
        self._rebuild()
        return True

    def remove(self, member: str) -> bool:
        """Remove a member; returns False when absent."""
        if member not in self._members:
            return False
        self._members = [m for m in self._members if m != member]
        self._rebuild()
        return True

    def _rebuild(self) -> None:
        n = len(self._members)
        if n == 0:
            self._positions = np.zeros(0, dtype=_U64)
            self._owners = np.zeros(0, dtype=np.int64)
            self._arc_place = np.zeros(0, dtype=np.int64)
            self._arc_vnode = np.zeros(0, dtype=np.int64)
            return
        pos = np.empty(n * self.vnodes, dtype=_U64)
        own = np.empty(n * self.vnodes, dtype=np.int64)
        for i, member in enumerate(self._members):
            for v in range(self.vnodes):
                pos[i * self.vnodes + v] = _vnode_position(member, v)
                own[i * self.vnodes + v] = i
        # Migrated arcs: the vnode keeps ITS position (placed by the
        # original member's hash — no other arc moves) but its keys are
        # served by the override target. Dangling entries (placer or
        # target no longer a member) are ignored, not an error: a swept
        # member's arcs must revert to hash ownership on their own.
        index = {m: i for i, m in enumerate(self._members)}
        for (member, vnode), target in self._overrides.items():
            i, t = index.get(member), index.get(target)
            if i is not None and t is not None and 0 <= vnode < self.vnodes:
                own[i * self.vnodes + vnode] = t
        order = np.argsort(pos, kind="stable")
        self._positions = pos[order]
        self._owners = own[order]
        # Arc identity (placing member, vnode index) in sorted-arc order:
        # the rebalancer ranks arcs by traffic and needs to name them.
        self._arc_place = np.repeat(np.arange(n, dtype=np.int64),
                                    self.vnodes)[order]
        self._arc_vnode = np.tile(np.arange(self.vnodes, dtype=np.int64),
                                  n)[order]

    # -- vnode ownership overrides (rebalancer actuation) --------------------
    @property
    def overrides(self) -> Tuple[Tuple[str, int, str], ...]:
        """Active ``(placing member, vnode, target)`` triples, sorted —
        the exact value the routing payload ships."""
        return tuple(sorted((m, v, t) for (m, v), t
                            in self._overrides.items()))

    def set_overrides(self,
                      triples: Iterable[Tuple[str, int, str]]) -> None:
        """Replace ALL overrides and rebuild (the routing-table path:
        clients apply the payload's full override list atomically)."""
        self._overrides = {(str(m), int(v)): str(t)
                           for m, v, t in triples}
        self._rebuild()

    def assign_vnode(self, member: str, vnode: int, target: str) -> None:
        """Point one vnode arc of ``member`` at ``target`` (the router's
        per-migration step). ``target == member`` clears the override."""
        check(0 <= int(vnode) < self.vnodes,
              f"vnode {vnode} out of range [0, {self.vnodes})")
        key = (str(member), int(vnode))
        if str(target) == str(member):
            self._overrides.pop(key, None)
        else:
            self._overrides[key] = str(target)
        self._rebuild()

    def arc_ids(self, keys: np.ndarray) -> List[Tuple[str, int]]:
        """Per key: the identity ``(placing member, vnode)`` of the arc
        that covers it — what a rebalancer aggregates traffic by. Uses
        the PLACING member, not the effective owner, so an arc keeps its
        name across migrations."""
        check(len(self._members) > 0, "hash ring has no members")
        hashed = _splitmix64(np.asarray(keys).reshape(-1))
        idx = np.searchsorted(self._positions, hashed, side="right")
        idx = np.where(idx == len(self._positions), 0, idx)
        return [(self._members[int(self._arc_place[i])],
                 int(self._arc_vnode[i])) for i in idx]

    # -- routing ------------------------------------------------------------
    def owner(self, key: int) -> str:
        """The member owning one integer key."""
        return self._members[int(self.owner_indices(
            np.asarray([key], dtype=np.int64))[0])]

    def owner_indices(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized: member INDEX (into ``self.members``) per key."""
        check(len(self._members) > 0, "hash ring has no members")
        hashed = _splitmix64(np.asarray(keys).reshape(-1))
        # First vnode clockwise of the key's position; wrap past the end.
        idx = np.searchsorted(self._positions, hashed, side="right")
        idx = np.where(idx == len(self._positions), 0, idx)
        return self._owners[idx]

    def partition(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """Group key POSITIONS by owning member: member id -> positions
        array into ``keys`` (the fan-out shape a routed lookup wants)."""
        keys = np.asarray(keys).reshape(-1)
        owners = self.owner_indices(keys)
        return {self._members[int(i)]: np.flatnonzero(owners == i)
                for i in np.unique(owners)}

    # -- replica sets --------------------------------------------------------
    def replica_set(self, key: int, n: int = 2) -> List[str]:
        """The first ``n`` DISTINCT members clockwise of ``key``'s ring
        position — the key's replica set, primary first. Generalizes
        :meth:`owner` (``replica_set(k, 1) == [owner(k)]``); the classic
        successor-list placement, so removing the primary hands the key
        to exactly the next member of its own set."""
        check(len(self._members) > 0, "hash ring has no members")
        n = min(max(1, int(n)), len(self._members))
        hashed = _splitmix64(np.asarray([key], dtype=np.int64))[0]
        size = len(self._positions)
        idx = int(np.searchsorted(self._positions, hashed,
                                  side="right")) % size
        out: List[str] = []
        for step in range(size):
            member = self._members[int(self._owners[(idx + step) % size])]
            if member not in out:
                out.append(member)
                if len(out) == n:
                    break
        return out

    def successors(self, member: str, n: int = 1) -> List[str]:
        """The first ``n`` DISTINCT members clockwise of ``member``'s
        vnodes, in arc order — the members that inherit its keys if it
        leaves the ring (its per-partition replica set, minus itself).
        Deterministic for a given membership, so routers and clients
        derive IDENTICAL failover preferences independently."""
        check(member in self._members, f"unknown ring member {member!r}")
        if len(self._members) <= 1 or n <= 0:
            return []
        me = self._members.index(member)
        size = len(self._positions)
        out: List[str] = []
        # _positions is sorted, so flatnonzero walks this member's vnodes
        # in ring order; for each, take the next arc's distinct owner.
        for i in np.flatnonzero(self._owners == me):
            for step in range(1, size):
                o = int(self._owners[(int(i) + step) % size])
                if o != me:
                    cand = self._members[o]
                    if cand not in out:
                        out.append(cand)
                    break
            if len(out) >= n:
                break
        return out[:n]
