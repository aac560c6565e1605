"""Distributed trace context: one request, one id, across every process.

Port of ``multiverso_tpu/telemetry/context.py``.

Spans alone stop at the process boundary — the serving stack (client ->
router proxy -> replica service -> batcher -> device -> reply) produces N
disconnected per-PID trace files. A :class:`TraceContext` is the fix: a
128-bit trace id plus a 64-bit span id/parent pair and a sampling flag,
carried on a THREAD-LOCAL stack inside a process and as one small uint64
blob on the DCN wire between processes, so every span a request touches —
in any process — shares one trace id with correct parent links.

Sampling is HEAD-BASED: the process that creates the root (the fleet or
serving client) draws once against ``-telemetry_sample_rate`` and every
downstream hop honors the decision carried in the flags word — an
unsampled request costs a dataclass and a flag read per hop, never a
trace-buffer append. Tail exemplars stay observable because the client
force-records its root span for requests that shed, error, or exceed
``-telemetry_slow_ms`` even when head-unsampled (downstream spans for
those requests are gone — the head decision already dropped them — but
the exemplar and its outcome are not).

Wire format (``to_wire``/``from_wire``): ``uint64[5]`` =
``[trace_hi, trace_lo, span_id, parent_id, flags]`` with flags bit0 =
sampled, bits 8.. = hedge attempt index. Rides the existing
length-prefixed blob framing (``parallel/net.py``) as one extra blob on
``Serve_Request``; absent blob = no context (old peers interoperate).

Stdlib + numpy only: every layer may import this without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["TraceContext", "current_context", "activate", "new_root",
           "child_of", "maybe_new_root", "sample_rate", "slow_ms",
           "to_wire", "from_wire", "WIRE_LEN"]

_FLAG_SAMPLED = 0x1
_HEDGE_SHIFT = 8

WIRE_LEN = 5

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of one span within one distributed trace. Immutable —
    derive children with :func:`child_of`, never mutate."""

    trace_id: int               # 128-bit
    span_id: int                # 64-bit, nonzero
    parent_id: int = 0          # 0 = root
    sampled: bool = True
    hedge: int = 0              # attempt index; >0 tags a hedged duplicate

    @property
    def trace_hex(self) -> str:
        return f"{self.trace_id:032x}"

    @property
    def span_hex(self) -> str:
        return f"{self.span_id:016x}"


class _TLS(threading.local):
    def __init__(self):
        self.stack = []
        # Per-thread generator: the module-level ``random`` lock would sit
        # on every request's hot path; per-thread instances contend never.
        self.rng = random.Random(os.urandom(16))


_tls = _TLS()


def _rng() -> random.Random:
    return _tls.rng


def current_context() -> Optional[TraceContext]:
    """Innermost active context of THIS thread (None outside any trace)."""
    stack = _tls.stack
    return stack[-1] if stack else None


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Make ``ctx`` the current context for the dynamic extent — the
    adoption point for a context that arrived over the wire or crossed a
    thread boundary (batcher worker, reader thread). ``None`` is a no-op
    so call sites need no conditional."""
    if ctx is None:
        yield
        return
    stack = _tls.stack
    stack.append(ctx)
    try:
        yield
    finally:
        stack.pop()


def sample_rate() -> float:
    """``-telemetry_sample_rate`` (0 disables request tracing entirely)."""
    try:
        from multiverso_tpu_torch.utils.configure import get_flag
        return float(get_flag("telemetry_sample_rate"))
    except Exception:  # noqa: BLE001 - flags not parsed (bare library use)
        return 0.02


def slow_ms() -> float:
    """``-telemetry_slow_ms``: latency past this force-records the root
    span of an unsampled request (tail exemplar)."""
    try:
        from multiverso_tpu_torch.utils.configure import get_flag
        return float(get_flag("telemetry_slow_ms"))
    except Exception:  # noqa: BLE001
        return 100.0


def new_root(sampled: Optional[bool] = None) -> TraceContext:
    """Fresh trace: new 128-bit id, head sampling decision drawn here
    (once per request, at the outermost client) unless forced."""
    rng = _rng()
    if sampled is None:
        rate = sample_rate()
        sampled = rate >= 1.0 or (rate > 0.0 and rng.random() < rate)
    return TraceContext(trace_id=rng.getrandbits(128),
                        span_id=rng.getrandbits(64) | 1,
                        parent_id=0, sampled=bool(sampled))


def maybe_new_root() -> Optional[TraceContext]:
    """Root for a request-path hot loop: ``None`` when the rate is 0 —
    tracing fully off costs one flag read, no ids, no wire blob."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    rng = _rng()
    sampled = rate >= 1.0 or rng.random() < rate
    return TraceContext(trace_id=rng.getrandbits(128),
                        span_id=rng.getrandbits(64) | 1,
                        parent_id=0, sampled=sampled)


def child_of(parent: Optional[TraceContext] = None,
             hedge: int = 0) -> TraceContext:
    """Child span identity under ``parent`` (default: the current
    context; a fresh root when there is none)."""
    if parent is None:
        parent = current_context()
    if parent is None:
        root = new_root()
        return root if hedge == 0 else \
            dataclasses.replace(root, hedge=hedge)
    return TraceContext(trace_id=parent.trace_id,
                        span_id=_rng().getrandbits(64) | 1,
                        parent_id=parent.span_id,
                        sampled=parent.sampled,
                        hedge=hedge)


def to_wire(ctx: TraceContext) -> np.ndarray:
    """``uint64[5]`` wire blob for the DCN framing."""
    flags = (_FLAG_SAMPLED if ctx.sampled else 0) \
        | (int(ctx.hedge) << _HEDGE_SHIFT)
    return np.asarray([(ctx.trace_id >> 64) & _MASK64,
                       ctx.trace_id & _MASK64,
                       ctx.span_id & _MASK64,
                       ctx.parent_id & _MASK64,
                       flags], dtype=np.uint64)


def from_wire(blob) -> Optional[TraceContext]:
    """Inverse of :func:`to_wire`; ``None`` on anything malformed — a bad
    trace blob must never fail the request riding next to it."""
    try:
        arr = np.asarray(blob, dtype=np.uint64).reshape(-1)
        if arr.size < WIRE_LEN:
            return None
        hi, lo, span_id, parent_id, flags = (int(x) for x in arr[:WIRE_LEN])
        if span_id == 0:
            return None
        return TraceContext(trace_id=(hi << 64) | lo, span_id=span_id,
                            parent_id=parent_id,
                            sampled=bool(flags & _FLAG_SAMPLED),
                            hedge=int(flags >> _HEDGE_SHIFT))
    except (TypeError, ValueError):
        return None
