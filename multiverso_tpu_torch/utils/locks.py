"""The ONE lock-construction seam: ``make_lock(name)``.

Port of ``multiverso_tpu/utils/locks.py``. Every lock of the port is built
through :func:`make_lock` / :func:`make_rlock` / :func:`make_condition`
with a literal ``<plane>.<what>`` witness name, so the static lock rules
and the runtime witness can later join on the same key.

With the witness off (the default) each factory returns the bare
``threading`` primitive — zero added cost. The runtime lock witness
(``telemetry/lockwitness.py`` in the JAX package) is not ported yet
(ROADMAP A11): turning it on raises ``NotImplementedError`` instead of
silently handing out unwitnessed locks.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["make_lock", "make_rlock", "make_condition",
           "witness_enabled", "set_witness_enabled"]

#: Tri-state override: None = follow env/flag; True/False = forced.
_forced: Optional[bool] = None


def set_witness_enabled(on: Optional[bool]) -> None:
    """Force the witness on/off for locks constructed from now on
    (``None`` restores env/flag control)."""
    global _forced
    _forced = on


def witness_enabled() -> bool:
    if _forced is not None:
        return _forced
    env = os.environ.get("MULTIVERSO_LOCKWITNESS", "")
    if env:
        return env.strip().lower() not in ("0", "false", "off", "no")
    from multiverso_tpu_torch.utils.configure import flag_or
    return bool(flag_or("lockwitness", False))


def _no_witness() -> None:
    if witness_enabled():
        raise NotImplementedError(
            "the runtime lock witness (-lockwitness / "
            "MULTIVERSO_LOCKWITNESS) is not ported yet: ROADMAP A11")


def make_lock(name: str) -> threading.Lock:
    """A named mutex (the bare ``threading.Lock``)."""
    del name
    _no_witness()
    return threading.Lock()


def make_rlock(name: str) -> threading.RLock:
    """A named re-entrant mutex (the bare ``threading.RLock``)."""
    del name
    _no_witness()
    return threading.RLock()


def make_condition(name: str, lock=None) -> threading.Condition:
    """A named condition variable over ``lock`` (a new mutex if None)."""
    del name
    _no_witness()
    return threading.Condition(lock)
