"""Double-buffered background prefetcher.

Parity with ``include/multiverso/util/async_buffer.h:11-116``: a background
thread runs the fill action into the idle buffer while the consumer uses the
ready one — the compute/IO overlap primitive used by both reference apps
(WordEmbedding block pipeline, LR pipelined model pulls).
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar
from multiverso_tpu_torch.utils.locks import make_condition

T = TypeVar("T")


class ASyncBuffer(Generic[T]):
    def __init__(self, fill_action: Callable[[], Optional[T]]):
        """``fill_action`` produces the next item, or None at end-of-stream."""
        self._fill = fill_action
        self._ready: Optional[T] = None
        self._has_item = False
        self._done = False
        self._cv = make_condition("core.async_buffer.cv")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._fill()
            with self._cv:
                while self._has_item and not self._done:
                    self._cv.wait()
                if self._done:
                    return
                self._ready = item
                self._has_item = True
                self._cv.notify_all()
                if item is None:
                    return

    def get(self, timeout: Optional[float] = None) -> Optional[T]:
        """Take the ready buffer (blocking); None signals end-of-stream."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._has_item or self._done,
                                     timeout):
                raise TimeoutError("ASyncBuffer fill timed out")
            item = self._ready
            self._ready = None
            self._has_item = False
            self._cv.notify_all()
            return item

    def close(self, timeout: float = 30.0) -> None:
        """Stop the filler and wait for its thread to exit (it finishes
        the fill in progress first), so no thread outlives the consumer."""
        with self._cv:
            self._done = True
            self._cv.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
